#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

All paths run ``task_finetune_irtr_coco_square_randaug_base_image384`` +
``ufo`` at the full width of ViT-B/16 @384 (bf16): 577 image tokens, 12
layers, C=768, 12 heads, MLP 3072; 40 text tokens.  Weights are random
from a seed, with a non-zero rel-pos bias table and q/v biases; images
and captions are synthetic.

  * the COCO/Flickr retrieval eval
    (``vl_merging_tpu_torch.evaluation.retrieval.compute_irtr_recall``);
  * the irtr fine-tune step (``vl_merging_tpu_torch.train.loop.
    build_train_step``): f32 master params, micro-batches of 32 image/
    caption pairs, 2 micro-batches per optimizer step, 3 steps, no warmup;
  * the W8A8 int8 retrieval eval (``eval_int8: True``, the int8 weights
    quantized by ``eval_cast_params``), and its image tower with the
    opt-in int8-QK attention (``qk_int8=True``);
  * the image tower under each of the eval block's four routes
    (``fusion``: "pair" K1 → K2 → K4 → K5, "tail" K1 → K2 → K3, "qkv"
    K8 → K3, "mega" K7), and the retrieval eval under "mega";
  * the irtr fine-tune step under the training fusion (``train_fusion``
    "tail": K6 for every block's post-attention half; "full": K1 for its
    LN1 + qkv too);
  * the Trainer (``train/loop.Trainer``: fit, validate, recall,
    checkpoints and resume), ``run.main`` and ``cache_gram_matrices.main``
    over arrows the script writes, read by the port's ``data/``;
  * the device-side preprocessing: the eval's uint8 canvas resized on the
    card, the Trainer's train augment and a pretrain step's MLM masking
    on the card.

The merging phase starts from the same config with ``all_moe`` (the
experts the merges fold into ufo).

The Flickr30k @224 retrieval eval runs
``task_finetune_irtr_f30k_square_randaug_base`` + ``ufo`` at the same
width: ViT-B/16 @224, 197 image tokens, whose attention takes the split
kernels (K11 for a batch of 4k, K10 otherwise).  The ViT-L phase runs
``task_finetune_irtr_f30k_square_randaug_large_image384`` + ``ufo`` at
full width and depth (C=1024, 16 heads, MLP 4096, 577 image tokens, 24
layers), and the routing check the vit-tiny width (C=192,
``task_test_vit_tiny_mlm_itm_ifm_square_randaug_base_vl``).

Phases, each fatal on failure:
  1. a CUDA device (printed as nvidia-smi names it, with its power limit);
  2. the kernels built from ``vl_merging_tpu_torch/csrc`` (build time),
     and the wgmma instructions of the redesigned kernels (HGMMA: K3, K4,
     K5, K6, K13 on the shared MLP body; K9's two kernels; K1, K2, K7, K8
     and K10/K11 (one kernel); IGMMA: K14, K15, K12; K7, K14 and K15 at
     each of their widths, 768 and 1024) counted in the library's SASS
     with ``cuobjdump`` (none: fail), and K12's I2F instructions beside
     K2's (its s32 logits convert on the integer and FP32 pipes: more
     than K2's, whose come from decoding items, fails); the
     registers and spill bytes ptxas gave K1, K2, K7 (and every function
     it calls), K8, K14, K15, K10/K11 and K12 (``build/nvcc.log``; a
     spill, or no instantiation of K7, K14 or K15 at C=1024, fails), and
     ptxas's warnings that it serialised a kernel's wgmma (one for K8,
     K14, K10/K11, K7, K15 or K12 fails);
  3. each kernel (K1 ln_linear, K2 packed_attention, K3 proj_mlp_tail,
     K9 packed_attention_bwd, K13 mlp, K12 packed_attention_i8qk, K14
     ln_linear_i8, K15 proj_mlp_tail_i8, K4 linear_residual, K5 mlp_tail,
     K8 ln_qkv_attention, K7 block_eval, K10 split_attention, K11
     split_attention_bb, K6 tail_train) at main-path shapes against its
     plain twin on the same inputs, with its tolerance and the share of
     elements that differ; kernel, twin and (where one PyTorch call
     computes the same function) library call timed with CUDA events,
     beside the least time the card could take; K14, K15 and K12 beside
     K1, K3 and K2 at the same shapes (K14 and K1, K12 and K2 in turns,
     K12 also at 16 heads, with its bar: at most 1.00 x K2, printed met or
     missed); the SHA-256 of K12's output; K4 + K5, K8
     and K7 beside the staged kernels they replace (K3, K1 + K2, K8 + K3),
     in time (in turns) and output (bit-equal or not, and the share of
     elements that differ); K10 beside K11 at B=32, K10 at B=6 beside
     K11's first 6 elements, K10 beside K2 on the packed qkv whose views
     it reads (N=197), and K6 at uniform gammas beside K3, likewise (K4 ->
     K5, K7 and K6 share K3's MLP body, K7, K8, K10 and K11 run K1's and
     K2's code: K4 -> K5, K6 and K7 not bit-equal to K3, K3 and K1 -> K2
     -> K3, K8 not bit-equal to K1 -> K2, K7 to K8 -> K3, or K10 to K11
     or K2, fails); K10 (B=6) and K11 (B=32) timed by device time alone
     (a CUDA graph of 100 launches) and per call, SDPA both ways, in
     turns, the wrappers' host µs per call beside K2's, and their bars
     (K11's device time at most 0.045 ms, K10's below SDPA's; printed,
     met or missed); K7's time against K1 + K2 + K3, K8's against K1 +
     K2, K15's against K3 and K14's against K1 beside their bars (1.25x,
     1.10x, 0.85x, 0.8x; printed, met or missed); K14's rounds and the
     SHA-256 of its output, K15's SHA-256; K15 with every
     gelu and a row of zero context against its twin; K1 at the text
     rows (32·40) and, as a yardstick the port never calls, one cuBLAS
     ``F.linear`` on the pre-normalised rows at each K1 shape; K2 at the
     ViT-L shape (B=32, 16 heads) against its twin, timed beside SDPA, its
     training launch too; K9 against its twin fed the plain forward's
     softmax statistics, not K2's, so that the twin is the plain backward
     throughout (D = Σ_k dp ⊙ p in f32 on both sides: fault C8); K2's
     training launch (it also stores the softmax statistics K9 reads),
     with and without a sample of no valid key: its context bit-equal to
     the eval launch's, its statistics against the plain ones, and K9 on
     the batch with that sample against its twin; timed beside its eval
     launch; K2's training launch and K9 again at B=32, N=617 under the
     joint mask of a fused pass (zeros inside the key range), K9 timed
     beside its twin, its bound and SDPA's autograd backward there (K9's
     row: ``at_617``); K1, K3, K13, K6, K4 and K5 also at the
     ViT-L width (C=1024) against their twins, timed beside their bound,
     and K4 -> K5 and K6 at uniform gammas bit-equal to K3 there; K8 at
     C=1024 (16 heads) and at N=901 (the @480 image tower) against its
     twin and bit-equal to K1 -> K2, timed beside them and its bound;
     K14, K15 (every gelu) and K7 at C=1024 (B=32, 16 heads, MLP 4096)
     against their twins, each timed in turns beside its staged yardstick
     (K1, K3, K1 -> K2 -> K3) with its bar (0.8x, 0.85x, 1.25x; printed),
     its plain twin and its bound, K14's rounds and the digests there, and K7
     bit-equal to K1 -> K2 -> K3 and to K8 -> K3 there;
  4. ``compute_irtr_recall`` over 64 images (batches of 32) and 320
     captions (batches of 64): K1-K3 launched 12 times per image batch,
     K13 12 times per text batch; finite features, image cls_feats within
     cosine 0.999 of the plain path's; the image tower's images/s on both
     paths; then the image tower under each ``fusion`` (launches per image
     batch: "pair" K1, K2, K4, K5 12 each; "tail" K1-K3 12 each; "qkv" K8
     and K3 12 each; "mega" K7 12; nothing else), finite cls_feats within
     cosine 0.999 of the plain path's, the least cosine between routes,
     and each route's images/s in turns; ``compute_irtr_recall`` under
     "mega" (K7 12 per image batch, K13 12 per text batch);
  5. the int8 eval: ``compute_irtr_recall`` (K14, K2 and K15 launched 12
     times per image batch, K1 = K3 = K12 = 0, K13 12 per text batch) and
     R@{1,5,10}; the image tower with ``qk_int8`` (K12 12 per image batch,
     K2 0); int8 kernel-path image features within cosine 0.999 of the
     int8 plain path's (``ops/int8.ref_fused_eval_block_i8``) in both
     modes, and their cosine to the bf16 kernel path's (printed, no
     gate); the image tower's images/s with int8 kernels, with the int8-QK
     kernels, int8 plain and the bf16 kernels by "tail" and by "mega", in
     turns;
  6. the irtr step: kernel-path losses within 5e-3 relative and
     gradients within global cosine 0.999 of the plain path's at the same
     params, micro-batch and random draws; a warm-up step and 2 steps of
     each path in turns: K2 and K9 launched 12 times and K13 24 times per
     micro-batch, finite loss and grad norm every step; step time, pairs/s
     and peak memory on both paths (best of 2);
  7. the Flickr30k @224 eval: ``compute_irtr_recall`` over 70 images
     (batches of 32, 32 and 6) and 350 captions (batches of 64): K11 12
     launches per full image batch, K10 12 for the batch of 6, K13 12 per
     image batch and per text batch, no other kernel; finite features,
     image cls_feats within cosine 0.999 of the plain path's; R@{1,5,10};
     the @224 image tower's images/s, kernels and plain path in turns;
  8. the training fusion: gradients of the irtr @384 step at
     ``train_fusion`` "tail" and "full" within global cosine 0.999 of
     level "0" (the kernel path) at the same params, batch and random
     draws; a warm-up step and 2 steps of each level in turns: per
     micro-batch K6 24 (12 image and 12 text blocks), K2 12, K9 12, no
     K13, and K1 24 under "full" only ("0": K2, K9 12, K13 24); finite
     loss and grad norm; step time, pairs/s and peak memory;
  9. ViT-L @384 (C=1024): the image tower over 32 images (K1, K2, K3
     launched 24 times, nothing else) and the text tower over 64 captions
     (K13 24 times), finite features within cosine 0.999 of the plain
     path's; the image tower again by ``fusion`` "qkv" (K8, K3 24 times)
     and by "mega" (K7 24 times), its features bit-equal to the default
     route's; the image tower in the W8A8 int8 eval (``eval_int8``: K14,
     K2, K15 24 times each), its features within cosine 0.999 of the int8
     plain path's; the image tower's images/s on the plain path, by "tail"
     and "mega" and in int8, in turns; two fine-tune steps at
     micro-batch 8 at ``train_fusion`` "0" (per step K2 24, K9 24, K13 48)
     and "full" (K2 24, K9 24, K6 48, K1 48), finite loss and grad norm;
     kernel-path gradients within global cosine 0.999 of the plain path's;
 10. the vit-tiny width (C=192): its image and text towers and two irtr
     steps at its width (``train_fusion`` "0" and "full") on the card
     launch no K1, K3, K13 or K6 (no kernel of theirs is built for 192;
     the routing takes the plain ops, as the JAX package takes XLA);
 11. the merging suite over ``task_finetune_irtr_coco_square_randaug_base_
     image384`` + ``all_moe`` at full width and depth (381 tensors, 210.5 M
     parameters): a seeded all_moe checkpoint and a seeded ufo "central"
     one written (``ckpt/io.save_torch_checkpoint``, Lightning envelope)
     and read back bit for bit; the gram pass (``train/gram.
     cache_gram_matrices``, irtr, f32 masters on the card) in
     ``f32_device`` over 64 pairs in batches of 32, and in ``f64_host``
     and ``f32_device`` over the first 8 pairs alone (K2 12 launches per
     image batch, nothing else: the taps turn off the fused eval block
     and K13), the irtr v/l key set, each gram symmetric and the two
     precisions within rows·2^-24 of the largest entry, with the host
     seconds and FLOP of the f64 products; ``merge.py`` by
     ``merge_weights`` (ratio 0.5), ``sum_task_vectors`` (λ 0.5, the
     central checkpoint) and ``regmean`` (the f64 grams, non-diagonal
     scaling 0.9), each ``merged.ckpt`` through ``ckpt/pipeline.
     load_params`` into ufo (``test_only``; no key missing or
     unexpected) and scored by ``compute_irtr_recall`` over 64 images
     and 320 captions (K1-K3 12 per image batch, K13 12 per text batch;
     features within cosine 0.999 and the ITC scores within
     ``MAX_SCORE_DELTA`` of the plain path's; recall printed beside the
     plain path's);
     device merging (``merging/device.py``): a fleet of 8 seeded all_moe
     checkpoints by ``merge_weights_device`` (a ratio per member) and
     ``sum_task_vectors_device``, a ``ratio_sweep`` of 11 ratios, every
     member within 4 ulp at operand scale of the host path
     (``merging/core.py``), checkpoints merged per second end to end
     (the copies to and from the card included) and by the merge alone
     beside the host seconds per checkpoint; ``regmean_device`` on the
     f64 grams cast to f32 against the host f64 regmean, each merged
     weight within ``regmean_bound`` of its summed grams' printed
     condition number and within ``REGMEAN_MEASURED_SHARE`` (0.1) of
     that bound, the limit set from the drift measured on an H100;
 12. the fused VL pass and the downstream eval (``model.infer``, seeded
     weights, captions of 5 to 40 valid tokens, so the joint key mask has
     zeros inside): VQA @480
     (``task_finetune_vqa_square_randaug_base_image384_ufo`` + ``ufo``,
     ``image_size`` 480: layers 0-9 split into the 40 text tokens and 901
     image tokens, layers 10-11 run the joint 941) through
     ``evaluation/downstream.vqa_predictions`` over 2 batches of 32
     questions: per batch K1, K2, K3 12 and K13 10 (the text halves'
     MLP), ``scan_k`` 2 giving scan_k 1's answers, a submission json
     written, logits within cosine 0.999 of the plain path's; in W8A8
     (``eval_int8``: K14, K2, K15 12 and K13 10 per batch, within cosine
     0.999 of the int8 plain path); questions/s, bf16 plain and kernels
     and W8A8, in turns; NLVR2 @384
     (``task_finetune_nlvr2_square_randaug_base_image384``) in ufo and
     all_moe over 32 pairs through ``train_step.compute_losses(...,
     train=False)`` (the paired pass: K1, K2, K3 24 and K13 20),
     ``nlvr2_correct`` through ``nlvr2_split_update`` and
     ``MetricAccumulator`` into ``the_metric``, the paired cls features
     within cosine 0.999 of the plain path's, pairs/s in turns; NLVR2 @224
     in ufo (197 image and 237 joint tokens, below ``KERNEL_MIN_N``: K11
     24 and K13 44, no K1, K2 or K3); the @384 fused pass by each
     ``fusion`` (K7 and K8 at N=617 in the deep layers), bit-equal to
     "tail"; the ITM rerank of phase 4's eval (the config with its ITM
     head; top 4, 64 pairs a fused pass: 24 passes, each K1-K3 12 and K13
     10) with its recall and wall seconds, the reranked log-probabilities
     within cosine 0.999 of the plain path's; K2 alone at N = 577 (a mask
     of ones), 617 and 941 (the joint mask) against its twin, timed beside
     SDPA and its bound (K2's row: ``at_577``, ``at_617``, ``at_941``);
     K11 at B=32 and K10 at B=30 on the (B, 12, 237, 64) views of a packed
     qkv under the joint mask (the @224 fused pass of phase 13's pretrain
     and VQA steps) against their twin, 4 ulps, timed the same way (their
     rows: ``at_237``);
 13. the training objectives at full width (ViT-B/16, bf16 over f32
     masters; seeded weights, synthetic batches, captions of 5 to 40
     valid tokens): (a) the NLVR2 @384 fine-tune
     (``task_finetune_nlvr2_square_randaug_base_image384`` + ``ufo``, 2
     micro-batches of 16 pairs a step: per step K2 and K9 40 at N=577 (the
     split layers' image halves) and 8 at N=617 (the joint layers), K13
     88), the kernel path at ``train_fusion`` "0", "tail" (K6 88 instead
     of K13) and "full" (and K1 88) and the plain path; then in
     ``all_moe`` (every vl-expert weight moves); (b) the VLMo pretrain
     @224 (``task_mlm_itm_ifm_square_randaug_base``, ``pallas_attention``
     on: the JAX package's automatic setting turns the kernels off below
     577 image tokens) of 32 pairs, mlm, ifm with both vlffn re-runs and
     itm with hard negatives (per step K11 62, K13 116), in ``all_moe`` and
     in ``ufo``; (c) the all-in-one pretrain
     (``task_all_in_one_pretraining``) on a mixed batch of 16 images, 16
     texts and 16 pairs (K11 86, K13 112), the MIM labels
     from the port's dVAE encoder (seeded weights written to a file and
     read back by ``dvae.make_mim_label_fn``; 112-px targets), its
     codebook ids on the card against the CPU f32 encoder's (at least 99%
     equal, each other one a near tie: top-2 gap below 1e-3 of the logit
     scale); (d) the VQA fine-tune @224 (30 questions: K10 12, K13 22) and
     the ImageNet @384 fine-tune (32 images: K2 and K9 12 at N=577, K13
     12) with ``optim_type`` "adamw", "adam" and "sgd".  Each path's
     losses and gradients against the plain path's on the same
     micro-batch, params, draws and ITM negatives (each loss within 5e-3
     relative, the gradients' global cosine >= 0.999; "tail" and "full"
     too); then a warm-up step and 2 steps of each compared path in turns
     (3 optimizer steps each): its launches as the routing gives them (K2
     and K9 counted by N too), every loss and the grad norm finite, step
     ms, pairs/s and peak memory (best of 2).

 14. the Trainer, the CLIs and the data pipeline
     (``train/loop.Trainer``, ``run.main``, ``cache_gram_matrices.main``,
     ``data/``), the COCO irtr @384 config + ``ufo`` at full width and
     depth over COCO karpathy arrows the phase writes (train, val and test
     each 32 random-noise JPEGs at 384 px with 5 captions, a vocabulary of
     its words): ``Trainer.fit`` for 3 steps of 2 micro-batches of 16
     (``_stack_micro``), validating after step 2 and at the end with the
     recall of both splits (launches as ``block_launches`` /
     ``tower_launches`` derive them: per micro-batch K2 and K9 12 at 577
     tokens and K13 24; per validation the eval step over the val loader's
     10 batches and both splits' recall, K1-K3 and K13 12 a batch), the
     metrics it logs, ``checkpoints/last`` (``weights.ckpt`` read back bit
     for bit, ``meta.json``, the full state ``state.pt``) and ``best``;
     ``validate`` and ``recall`` alone, timed; a second Trainer resumed
     from "last" (``resume_during_pretraining``) for step 4 against a third
     that takes 4 steps uninterrupted: each loss within 5e-3 relative, the
     params at cosine 0.999 (bit-equal or not, printed); the Trainer's
     step timed as phase 6 times its own; ``run.main`` through a fit on the
     config's RandAugment and through ``validation_only``; and
     ``cache_gram_matrices.main`` on ``all_moe`` (2 batches of 16,
     ``f32_device``: K2 12 a batch) held against phase 11's gram pass on
     the same batches and params (rows·2^-24·max|g|).  It prints the fit's
     wall, the host's wait per step on the loader and on ``device_feed``,
     peak memory and the validation and recall walls, with the card's name
     and power limit.
 15. distribution (``parallel/``), phase 14's step (the COCO irtr @384
     config + ``ufo``, a global batch of 2 x 16 pairs): (a) at world 1
     under NCCL (``parallel.initialize``, world size 1, rank 0; one NCCL
     all-reduce probed), bit-equal to the same step without a process
     group; (b) two ranks on cuda:0 under gloo, spawned by
     ``torch.multiprocessing`` after the parent built the kernels (the
     ranks load them): their step's loss and averaged gradients over 16
     pairs each against one process's over the 32 at ``dp_scale`` 1/2
     (LOSS_REL, global cosine 0.999); the data-parallel and the sharded
     (``use_sharded_training``: an fsdp axis of 2, half of every large
     param a rank) steps, a warm-up step and 2 timed, and one more with
     the time inside the collectives, the sharded update at cosine 0.999
     to the data-parallel one; the Trainer over the ranks (a fit of 2
     steps with its validation and recall, checkpoints written by rank 0
     alone, ``validate`` and ``recall`` alone, the recall equal to one
     process's on the checkpoint rank 0 wrote with the towers fed the
     ranks' row shares (and printed beside it fed whole batches), a fit
     resumed from it on both ranks); each rank's launches as ``block_launches`` /
     ``trainer_launches`` derive them.  It prints the step's wall at
     world 1 and 2 and the time in collectives, with the card's name and
     power limit.  A rank's failure fails the phase.

 16. device-side preprocessing (``ops/image.py``, ``ops/augment.py``,
     ``ops/text_masking.py``, the train step's ``device_augment`` and
     ``device_mlm``): (a) bench.py's end-to-end eval image path on the
     COCO irtr @384 config + ``ufo``: 64 seeded photo-like images at
     native sizes up to 640 (one upscales) packed on a uint8 canvas
     (``pack_canvas``), copied to the card as uint8, resized there
     (``resize_normalize_nchw``) and run through the image tower by
     "tail" (K1-K3 12 a batch of 32); the resize's bytes against PIL's
     (the JAX package's bound: ≥ 99.7% exact, max |Δ| ≤ 2, mean < 0.005;
     a TF32 product would break it), its ms, the features against the
     PIL-resized f32 path's (cosine 0.999; bit-equal or not, printed) and
     both paths' img/s in turns; (b) ``Trainer.fit`` with
     ``device_augment`` (2 steps of 2 x 16 pairs, a validation) over
     arrows of random-noise JPEGs at mixed native sizes, one larger than
     the canvas, beside the same fit on the host's RandAugment: launches
     as ``trainer_launches`` derives them, every loss finite, the host's
     wait per step on the loader and on ``device_feed``; one loaded
     micro-batch's ``augment_train_batch`` on the card against the port
     on the CPU (≥ 99.9% equal, max |Δ| ≤ 2); (c) the VLMo pretrain @224
     (all_moe, 32 pairs) through ``build_train_step`` with
     ``device_mlm`` (whole-word) and ``device_augment`` on uint8 canvases
     and word-id maps, in turns with the same step on phase 13's
     host-made inputs (launches as phase 13's; step ms); the whole-word
     masking core on the card bit-equal to the CPU's on the same draws,
     labels -100 off the mask, no special token masked.
 17. the multi-device dry run and the named configs no other phase runs:
     (a) ``graft_entry.dryrun_multichip(4)`` on cuda:0 under gloo at full
     width (``task_mlm_itm_ifm_square_randaug_base_vl`` + ``all_moe``:
     ViT-B/16 @224, 197 image and 40 text tokens, 8 rows a rank on a data
     2 x fsdp 2 mesh, ``use_sharded_training``), against one process on
     the same card over the global batch of 32 with the same draws (its
     ITM negatives replayed in the ranks): the first step's losses within
     LOSS_REL and its averaged gradients at global cosine 0.999, each
     rank's state 0.500 of the full state's bytes (its shards alone), the
     sharded recall equal to one process's (fed the ranks' row shares),
     the merged ufo state bit-equal to ``merge_weights`` of the same
     gathered host state and its recall equal, the VQA @384 submission
     one json equal to one process's; each rank's launches stage by stage
     as derived (K11 and K13: 197 and 237 tokens are below
     ``KERNEL_MIN_N``), the step's ms a rank, its share in collectives
     (``collective_time``) and each stage's seconds; the base_vl step in
     one process (32 pairs), kernel path against plain path, timed; (b)
     the ViT-L VQA (``task_finetune_vqa_square_randaug_large_image384_ufo``
     + ``ufo`` at 384 px: C=1024, 16 heads, 21 split layers of 40 + 577
     tokens and 3 joint of 617) at full width and depth: the fused pass
     over 2 x 32 questions by "tail" and in W8A8 (launches as derived,
     logits cosine 0.999 to the plain path, questions/s in turns), and by
     "qkv" (K8) and "mega" (K7) at C=1024, 16 heads and N=617 under the
     joint mask (launches, logits bit-equal to "tail"'s or else within
     K7's 4-ulp bound, the reading printed; questions/s beside), the
     fine-tune step at micro-batch 8 against the plain path and timed
     (K2 and K9 at N=577 x 21 and N=617 x 3 a pass), K2 at N = 577 and
     617 and K2's training launch and K9 at N = 617 under the joint mask
     at 16 heads against their twins within their ulps (rows: ``at_577_h16``,
     ``at_617_h16``, ``train_at_617_h16``); (c) ImageNet @224
     (``img_cls``, 32 images: K11 and K13 12 a step) and the MSR-VTT frame
     fine-tune (ufo, one frame, irtr + ifm + itm over 32 pairs), kernel
     path against plain path, timed.
 18. the partial-MoE modes (``ln_moe``, ``attn_moe``, ``ffn_moe``; the
     paper's "which modules to keep per modality" study) at ViT-B/16
     width, each: (a) the COCO @384 retrieval eval (64 images, 320
     captions) of the mode's seeded checkpoint (its LayerNorms drawn too)
     by "tail", scored as phase 11's merged evals, img/s in turns; (b) the NLVR2 @384 fused pass over 32 pairs
     (ln_moe's shallow layers composed: per-half LayerNorms around the
     shared K2 and K13 over the joint 617 tokens; attn_moe's and
     ffn_moe's split), launches as derived at the real thresholds, the
     logits at cosine 0.999 to the plain path, pairs/s in turns; (c) the
     irtr @384 step (32 pairs; K2, K9, K13) and the pretrain @224
     (``task_mlm_itm_ifm_square_randaug_base`` + the mode, 32 pairs; K11,
     K13) against the plain path (losses within LOSS_REL) and in turns;
     (d) the mode's seeded checkpoint written and read back, its gram pass
     through the taps (f32_device, 32 pairs; the keys the reference's
     lists give the mode), ``merge.py`` by each method into ufo, each
     merged checkpoint's ``load_params`` and retrieval eval, a fleet of 4
     on the card within 4 ulp of the host and ``regmean_device`` within
     its κ bound; (e) the same suite at ViT-L @384
     (``task_finetune_irtr_f30k_square_randaug_large_image384`` +
     ``all_moe`` into ``ufo``: C=1024, 24 layers; the gram pass K2 at 16
     heads and N=577, the merged eval K1-K3 at C=1024), its parameter and
     gram counts and bytes printed beside the reckoning and ``free -g``.

Each phase prints its seconds.  Each row of the ``{"kernels": ...}`` line
carries the widths it was held at (``widths``) and, for the kernels built
for 1024, its figures there (``at_1024``), and its launches on each
phase's path (``launches_<path>``; ``launches_distribution`` counts phase
15's, both ranks' included; ``launches_preprocess`` phase 16's;
``launches_dryrun`` phase 17 (a)'s four ranks', ``launches_configs`` the
rest of phase 17's, ``launches_modes`` phase 18 (a)-(d)'s,
``launches_merging_large`` phase 18 (e)'s).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.

``python3 chip_smoke.py --digests`` prints only the SHA-256 of the
outputs of K2, K7, K8, K10, K11, K12, K14 and K15 at C=768 on phase 3's
seeded inputs (``chip_profile.py --digests TREE`` compares them with
another tree's on the same inputs).
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import functools
import hashlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from vl_merging_tpu_torch import dvae, graft_entry, merge
from vl_merging_tpu_torch.ckpt.convert import eval_cast_params, \
    master_params, params_from_numpy
from vl_merging_tpu_torch.ckpt.io import load_torch_checkpoint, \
    params_to_state_dict, save_torch_checkpoint
from vl_merging_tpu_torch.ckpt.pipeline import load_params
from vl_merging_tpu_torch.config import build_config
from vl_merging_tpu_torch.device import require_cuda
from vl_merging_tpu_torch.evaluation import downstream, metrics
from vl_merging_tpu_torch.evaluation.retrieval import compute_irtr_recall, \
    extract_features, itm_rerank_scores, retrieval_recall
from vl_merging_tpu_torch.merging import core as merging
from vl_merging_tpu_torch.merging import device as merging_device
from vl_merging_tpu_torch.models import model, mome
from vl_merging_tpu_torch.models.layers import layer_norm
from vl_merging_tpu_torch.models.spec import VL, init_params, \
    make_model_spec
from vl_merging_tpu_torch.models.taps import MOE_GRAM_SUFFIXES, \
    UFO_GRAM_SUFFIXES
from vl_merging_tpu_torch.ops import _build
from vl_merging_tpu_torch.ops import attention as attn_ops
from vl_merging_tpu_torch.ops import fused_block as fb_ops
from vl_merging_tpu_torch.ops import int8 as i8_ops
from vl_merging_tpu_torch.ops import mlp as mlp_ops
from vl_merging_tpu_torch.train import objectives, train_step
from vl_merging_tpu_torch.train.gram import cache_gram_matrices, \
    make_capture_step, make_gram_step, save_gram_matrices
from vl_merging_tpu_torch.train.loop import Trainer, accum_steps, \
    build_train_step
from vl_merging_tpu_torch.utils.profiling import collective_time, \
    storage_bytes

SEED = 0
CONFIG = ("task_finetune_irtr_coco_square_randaug_base_image384", "ufo")
IMAGE_BATCH, N_IMAGES = 32, 64
CAPTIONS_PER_IMAGE, TEXT_BATCH = 5, 64
MICRO_BATCH = 32
# a training path's steps: one warm-up step, then TIMED_STEPS steps timed in
# turns with the paths it is compared with
TIMED_STEPS = 2
TRAIN_STEPS = 1 + TIMED_STEPS
N, C, HEADS, HIDDEN = 577, 768, 12, 3072
# the joint layers of the @384 fused pass: 40 text and 577 image tokens;
# of the @224 one: 40 and 197
JOINT_N, JOINT_N_224 = 617, 237
# the Flickr30k @224 eval (ViT-B/16 @224: 197 image tokens): full image
# batches of 32 take K11, the ragged last batch of 6 K10
CONFIG_224 = ("task_finetune_irtr_f30k_square_randaug_base", "ufo")
N_224, N_IMAGES_224, K10_BATCH = 197, 70, 6
# ViT-L @384 (C=1024, 16 heads, MLP 4096, 577 image tokens, 24 layers):
# the image tower over 32 images, the text tower over 64 captions, and
# fine-tune steps at micro-batch 8, all at full depth
CONFIG_L = ("task_finetune_irtr_f30k_square_randaug_large_image384", "ufo")
L_IMAGES, L_CAPTIONS, L_MICRO, L_STEPS = 32, 64, 8, 2
C_L, HEADS_L, HIDDEN_L = 1024, 16, 4096
# the kernels built for both widths, held against their twins at C=1024 too
WIDE = ("ln_linear", "proj_mlp_tail", "mlp", "tail_train", "linear_residual",
        "mlp_tail")
# the vit-tiny width (C=192): no K1/K3/K13/K6 is built for it
CONFIG_TINY = ("task_test_vit_tiny_mlm_itm_ifm_square_randaug_base_vl",
               "ufo")
TINY_KERNELS = ("ln_linear", "proj_mlp_tail", "mlp", "tail_train")
BF16_ULP = 2.0 ** -7
# Kernel vs twin: K1, K3 and K13 round where their twins do, so they differ
# by f32 summation order (and erf's last f32 ulp): 2 bf16 ulps.  K2 rounds
# exp(s - running max) to bf16 before normalising, its twin the
# normalised probabilities, and it adds the bias inside the f32
# accumulation of q·kᵀ: 4 ulps.  K9 rounds p and ds where its twin does,
# but a ds on the other side of a rounding boundary moves the dq/dk sums
# it enters: 4 ulps; its f32 dbias (a sum over 32 samples) is held to a
# relative norm error of 1e-3.  The int8 kernels quantize as their twins
# do and sum s8·s8 products exactly in s32; the f32 LayerNorm statistics
# are summed in another order, which can move a quantized value across a
# rounding tie: K14 2 ulps, K15 (three chained quantizers) 4; K12 rounds
# its softmax as K2 does: 4.  K4 and K5 round where their twins do (K3's
# two halves): 2 ulps.  K8 rounds its softmax as K2 does: 4 ulps.  K7's
# context is K2's, whose 4-ulp error the proj carries, scaled down by
# γ1·Wp (|γ1| ~ 0.1 at these inputs), so the output adds to K3's own 2
# ulps a small fraction of 4: 4 ulps.  K10 and K11 round their softmax
# as K2 does: 4 ulps.  K6 is K3 with per-element gammas, rounding where
# its twin (K3's) does: 2 ulps.
ULPS = {"ln_linear": 2, "packed_attention": 4, "proj_mlp_tail": 2,
        "packed_attention_bwd": 4, "mlp": 2, "ln_linear_i8": 2,
        "proj_mlp_tail_i8": 4, "packed_attention_i8qk": 4,
        "linear_residual": 2, "mlp_tail": 2, "ln_qkv_attention": 4,
        "block_eval": 4, "split_attention": 4, "split_attention_bb": 4,
        "tail_train": 2}
DBIAS_REL = 1e-3
# K2's training launch against packed_attention_stats_reference: m and l
# are f32 sums of the same bf16 products in another order (and l of
# exponentials taken in steps of the running max), relative error 1e-5
STATS_REL = 1e-5
MIN_COSINE = 0.999
# the largest difference the ITC scores (cosines of unit features) may
# show between the kernel and the plain path in a retrieval eval: four
# times the largest an H100 read (1.02e-3 to 1.08e-3, the partial-MoE
# modes at ViT-B/16 with seeded weights)
MAX_SCORE_DELTA = 4e-3
# a training path's losses against the plain path's on the same step: each
# within LOSS_REL relative (the sound runs on the H100 read at most 5.7e-4,
# bf16 activations against the plain path's f32 logits)
LOSS_REL = 5e-3
TIMED_ITERS = 20
# launches per CUDA graph when a kernel's device time is taken alone
GRAPH_LAUNCHES = 100
# the time bars of the Hopper K7, K8, K15 and K14 (printed, met or missed):
# K7 at most 1.25 x the staged K1 -> K2 -> K3, K8 1.10 x K1 -> K2, K15 0.85
# x K3, K14 0.8 x K1, at the same shapes, in the same run
K7_BAR, K8_BAR, K15_BAR, K14_BAR = 1.25, 1.10, 0.85, 0.8
# K12 at most 1.00 x K2 at the same shapes, in turns (printed, met or
# missed): its int8 q·kᵀ halves the tensor-core term of K2's
K12_BAR = 1.00
# K11's device time at B=32, N=197 at most 0.045 ms; K10's at B=6 below
# SDPA's on the same inputs (printed, met or missed)
K11_BAR_MS = 0.045
# H100 SXM peaks (NVIDIA data sheet): dense bf16 and int8 tensor cores,
# HBM3
PEAK_BF16_FLOPS, PEAK_INT8_OPS, PEAK_BYTES = 989e12, 1979e12, 3.35e12


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


def device_ms(fn, launches: int = GRAPH_LAUNCHES) -> float:
    """The device time of one call of ``fn`` alone: ``launches`` calls
    captured in a CUDA graph, the graph replayed between two events (best
    of 3 replays), per call.  No host work runs between the launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / launches)
    del graph
    return best


def host_us(fn, calls: int = 200) -> float:
    """The host's time per call of ``fn`` (µs) over ``calls`` calls issued
    back to back without a synchronise (the launches queue on the device),
    after a warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def in_turns(a, b, timer=time_ms) -> tuple:
    """The best of two timings (ms) each of a and b, taken a, b, b, a."""
    ta, tb = [timer(a)], [timer(b)]
    tb.append(timer(b))
    ta.append(timer(a))
    return min(ta), min(tb)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, bytes_: float, int8_ops: float = 0.0) -> tuple:
    """The least time (ms) the card could take: the larger of the
    operations over their peak (bf16 flops, int8 ops) and the bytes over
    the memory rate."""
    t_ops = flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS
    t_bytes = bytes_ / PEAK_BYTES
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

    def q(*shape):   # an int8 weight and its per-channel scales
        return i8_ops.quantize_weight(r(*shape, s=0.02))

    mask = torch.ones(B, N, dtype=torch.int32, device=dev)
    mask[-1, 500:] = 0   # exercise the key mask too
    inputs = {
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
                                 mask, r(B, N, C, bf16=True)),
        "mlp": (r(B, N, C, bf16=True), r(HIDDEN, C, s=0.02, bf16=True),
                r(HIDDEN, s=0.1), r(C, HIDDEN, s=0.02, bf16=True),
                r(C, s=0.1)),
        "ln_linear_i8": (r(B, N, C, bf16=True), r(C, s=0.1, shift=1.0),
                         r(C, s=0.1), *q(3 * C, C), r(3 * C, s=0.1)),
        "proj_mlp_tail_i8": (r(B, N, C, bf16=True), *q(C, C), r(C, s=0.1),
                             r(C, s=0.1), r(B, N, C, bf16=True),
                             r(C, s=0.1, shift=1.0), r(C, s=0.1),
                             *q(HIDDEN, C), r(HIDDEN, s=0.1), *q(C, HIDDEN),
                             r(C, s=0.1), r(C, s=0.1)),
        "packed_attention_i8qk": (r(B, N, 3 * C, bf16=True), r(HEADS, N, N),
                                  mask, 64 ** -0.5, HEADS),
    }

    def split(b):
        """An @224 image block's attention inputs: the (b, H, 197, 64)
        views of a packed qkv, the f32 bias and a key mask."""
        qkv = r(b, N_224, 3 * C, bf16=True)
        q, k, v = qkv.view(b, N_224, 3, HEADS, 64).permute(2, 0, 3, 1, 4)
        m = torch.ones(b, N_224, dtype=torch.int32, device=dev)
        m[-1, N_224 - 40:] = 0
        return q, k, v, r(HEADS, N_224, N_224), m, 64 ** -0.5

    inputs["split_attention"] = split(K10_BATCH)
    inputs["split_attention_bb"] = split(B)
    # K9 reads the softmax statistics of K2's training launch (its twin the
    # plain forward's: ``plain_args``)
    qkv, bias, mask, g = inputs["packed_attention_bwd"]
    _, stats = attn_ops.packed_attention(qkv, bias, mask, 64 ** -0.5, HEADS,
                                         with_stats=True)
    inputs["packed_attention_bwd"] = (qkv, bias, mask, g, stats, 64 ** -0.5,
                                      HEADS)
    return inputs


def plain_args(name: str, args):
    """A twin's arguments: the kernel's, except that K9's twin reads the
    softmax statistics of the plain forward, not K2's, so that its p is
    the plain softmax of qkv, bias and mask: the twin is the plain
    backward throughout (D = Σ_k dp ⊙ p in f32 on both sides: fault C8)."""
    if name != "packed_attention_bwd":
        return args
    qkv, bias, mask, g, _, scale, heads = args
    return (qkv, bias, mask, g,
            attn_ops.packed_attention_stats_reference(qkv, bias, mask, scale,
                                                      heads),
            scale, heads)


def check_backward(args, want, label: str) -> float:
    """K9's (dqkv, dbias) against its twin's: dqkv within its ulps, dbias
    within DBIAS_REL; returns max |dqkv - twin|."""
    (got, dbias), (want, dbias_want) = \
        attn_ops.packed_attention_bwd(*args), want
    torch.cuda.synchronize()
    rel = float((dbias - dbias_want).norm() / dbias_want.norm())
    max_err, worst, differ = ulp_check("packed_attention_bwd", got, want)
    print(f"packed_attention_bwd{label}: dbias relative norm error "
          f"{rel:.3e} (bound {DBIAS_REL}); max |kernel - twin| = "
          f"{max_err:.6g}, worst err/bound = {worst:.3f} (bound "
          f"{ULPS['packed_attention_bwd']} bf16 ulps), {differ:.3e} of the "
          f"elements differ")
    if not bool(torch.isfinite(dbias).all()) or rel > DBIAS_REL:
        fail(f"packed_attention_bwd{label}: dbias disagrees with its twin")
    if not bool(torch.isfinite(got).all()) or worst > 1.0:
        fail(f"packed_attention_bwd{label} disagrees with its plain twin")
    return max_err


def check_training_attention(args, card: str) -> float:
    """K2's training launch against its plain versions, on K9's inputs and
    on them with sample 0 given no valid key: its context bit-equal to the
    eval launch's, its statistics within STATS_REL of
    ``packed_attention_stats_reference`` (l = 0 exactly on a row with no
    valid key, where K9 keeps p = 0); and K9 on the batch with that sample
    against its twin fed the plain forward (``plain_args``), its dead
    sample's gradient zero."""
    qkv, bias, mask, g, _, scale, heads = args
    dead = mask.clone()
    dead[0] = 0
    for label, m in (("", mask), (" (sample 0 with no valid key)", dead)):
        ctx, stats = attn_ops.packed_attention(qkv, bias, m, scale, heads,
                                               with_stats=True)
        ctx_eval = attn_ops.packed_attention(qkv, bias, m, scale, heads)
        ref = attn_ops.packed_attention_stats_reference(qkv, bias, m, scale,
                                                        heads)
        torch.cuda.synchronize()
        same = torch.equal(ctx.nan_to_num(), ctx_eval.nan_to_num())
        live = ref[1] > 0
        err = ((stats - ref).abs() / (1.0 + ref.abs()))[:, live]
        worst = float(err.max()) / STATS_REL
        dead_l = bool((stats[1][~live] == 0).all())
        print(f"packed_attention training launch{label}: context bit-equal "
              f"to the eval launch {same}; statistics (m, l) worst "
              f"|kernel - plain| / (1 + |plain|) = {worst * STATS_REL:.3e} "
              f"(bound {STATS_REL}) on {int(live.sum())} rows, l = 0 on the "
              f"{int((~live).sum())} rows with no valid key {dead_l}")
        if not same:
            fail(f"packed_attention training launch{label}: its context "
                 f"differs from the eval launch's")
        if not bool(torch.isfinite(stats[:, live]).all()) or worst > 1.0 \
                or not dead_l:
            fail(f"packed_attention training launch{label}: its softmax "
                 f"statistics disagree with the plain ones")
    k9 = (qkv, bias, dead, g, stats, scale, heads)
    check_backward(k9, attn_ops.packed_attention_bwd_reference(
        *plain_args("packed_attention_bwd", k9)),
        " (sample 0 with no valid key)")
    if attn_ops.packed_attention_bwd(*k9)[0][0].float().any():
        fail("packed_attention_bwd: a sample with no valid key has a "
             "nonzero gradient")
    train_ms = time_ms(lambda: attn_ops.packed_attention(
        qkv, bias, mask, scale, heads, with_stats=True))
    eval_ms = time_ms(lambda: attn_ops.packed_attention(
        qkv, bias, mask, scale, heads))
    print(f"packed_attention training launch (with the softmax statistics "
          f"K9 reads): {train_ms:.4f} ms against the eval launch "
          f"{eval_ms:.4f} ms at K9's inputs [{card}]")
    return train_ms


def check_joint_backward(dev, gen, rows, card: str,
                         heads: int = HEADS) -> None:
    """K2's training launch and K9 at a fused pass's joint layers (B=32,
    N=617, the joint mask: zeros inside the key range; ``heads`` heads of
    64) as at N=577: the context bit-equal to the eval launch's, the
    statistics within STATS_REL of the plain ones, K9 against its twin fed
    the plain forward (dqkv within its ulps, dbias within DBIAS_REL); K9
    timed beside its twin, its bound and SDPA's autograd backward (K9's
    row: ``at_617``; the training launch in K2's: ``train_at_617``; at
    other than 12 heads the keys end in ``_h{heads}``)."""
    n, scale, c = JOINT_N, 64 ** -0.5, 64 * heads
    qkv = torch.randn(IMAGE_BATCH, n, 3 * c, device=dev,
                      generator=gen).bfloat16()
    bias = torch.randn(heads, n, n, device=dev, generator=gen)
    mask = joint_mask(n, dev, gen)
    g = torch.randn(IMAGE_BATCH, n, c, device=dev, generator=gen).bfloat16()
    ctx, stats = attn_ops.packed_attention(qkv, bias, mask, scale, heads,
                                           with_stats=True)
    ctx_eval = attn_ops.packed_attention(qkv, bias, mask, scale, heads)
    ref = attn_ops.packed_attention_stats_reference(qkv, bias, mask, scale,
                                                    heads)
    torch.cuda.synchronize()
    same = torch.equal(ctx, ctx_eval)
    err = float(((stats - ref).abs() / (1.0 + ref.abs())).max())
    label = f" at N={n} (B={IMAGE_BATCH}, {heads} heads, joint mask, " \
        f"{int((mask == 0).sum())} zeros inside)"
    print(f"packed_attention training launch{label}: context bit-equal to "
          f"the eval launch {same}; statistics (m, l) worst |kernel - plain|"
          f" / (1 + |plain|) = {err:.3e} (bound {STATS_REL})")
    if not same or not bool(torch.isfinite(stats).all()) or err > STATS_REL:
        fail(f"packed_attention training launch{label} disagrees with its "
             f"eval launch or the plain statistics")
    args = (qkv, bias, mask, g, stats, scale, heads)
    twin_args = plain_args("packed_attention_bwd", args)
    max_err = check_backward(
        args, attn_ops.packed_attention_bwd_reference(*twin_args), label)
    ms = time_ms(lambda: attn_ops.packed_attention_bwd(*args))
    plain_ms = time_ms(lambda: attn_ops.packed_attention_bwd_reference(
        *twin_args), iters=TIMED_ITERS // 2)
    library_ms = time_ms(library_call("packed_attention_bwd", args))
    train_ms = time_ms(lambda: attn_ops.packed_attention(
        qkv, bias, mask, scale, heads, with_stats=True))
    bound_ms, bound_by = bound(*work("packed_attention_bwd", args))
    print(f"packed_attention_bwd{label}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA backward {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); K2's training launch there "
          f"{train_ms:.4f} ms [{card}]")
    at = f"at_{n}" + ("" if heads == HEADS else f"_h{heads}")
    for name in ("packed_attention", "packed_attention_bwd"):
        if c not in rows[name].setdefault("widths", []):
            rows[name]["widths"].append(c)
    rows["packed_attention_bwd"][at] = {
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "heads": heads}
    rows["packed_attention"][f"train_{at}"] = {"ms": train_ms,
                                               "stats_rel_err": err,
                                               "heads": heads}


def fusion_inputs(inputs):
    """The fusion kernels' inputs, made of K1-K3's (no new draws): K4 and
    K5 take K3's two halves (K5 fed K4's twin's x'), K8 K1's x, LN and
    weights with K2's bias and mask, K7 those and K3's weights."""
    x, ln1_w, ln1_b, w_qkv, qkv_bias = inputs["ln_linear"]
    _, bias, mask, scale, heads = inputs["packed_attention"]
    ctx, wp, bp, g1, res, ln2_w, ln2_b, w1, b1, w2, b2, g2 = \
        inputs["proj_mlp_tail"]
    attn = (x, ln1_w, ln1_b, w_qkv, qkv_bias, bias, mask, scale, heads)
    x1 = fb_ops.linear_residual_reference(ctx, wp, bp, g1, res)
    return {"linear_residual": (ctx, wp, bp, g1, res),
            "mlp_tail": (x1, ln2_w, ln2_b, w1, b1, w2, b2, g2),
            "ln_qkv_attention": attn,
            "block_eval": attn + (wp, bp, g1, ln2_w, ln2_b, w1, b1, w2, b2,
                                  g2)}


def train_fusion_inputs(inputs, gen):
    """K6's inputs: K3's, with per-element effective gammas (B, 1, C) bf16
    of stochastic-depth scales drawn from {0, 1/keep} as
    ``model._dp_scale_table`` draws them (keep 0.9, the last layer's at
    drop rate 0.1)."""
    ctx, wp, bp, g1, res, ln2_w, ln2_b, w1, b1, w2, b2, g2 = \
        inputs["proj_mlp_tail"]
    keep = 0.9
    dp = (torch.rand(2, ctx.shape[0], device=ctx.device, generator=gen)
          < keep).float() / keep
    ge1, ge2 = (dp[i][:, None, None].bfloat16() * g.bfloat16()
                for i, g in enumerate((g1, g2)))
    return {"tail_train": (ctx, wp, bp, ge1, res, ln2_w, ln2_b, w1, b1, w2,
                           b2, ge2)}


def _valid_keys(mask) -> int:
    return int(mask.sum())


def work(name: str, args) -> tuple:
    """(bf16 flops, bytes, int8 ops) the function needs on these inputs:
    each input read once, each output written once, products over valid
    keys only (K15's second fc1 pass is not required work)."""
    if name == "ln_linear":
        x, lw, lb, w, b = args
        M, O = x.shape[0] * x.shape[1], w.shape[0]
        return 2 * M * x.shape[-1] * O, nbytes(x, lw, lb, w, b) + M * O * 2
    if name == "packed_attention":
        qkv, bias, mask, _, heads = args
        flops = 4 * 64 * qkv.shape[1] * heads * _valid_keys(mask)
        return flops, nbytes(qkv, bias, mask) + qkv.numel() // 3 * 2
    if name in ("split_attention", "split_attention_bb"):
        q, k, v, bias, mask = args[:5]
        n = q.shape[2]
        flops = 4 * 64 * n * HEADS * _valid_keys(mask)
        return flops, nbytes(q, k, v, bias, mask) + nbytes(q)
    if name in ("proj_mlp_tail", "tail_train"):
        M, c, h = args[0].shape[0] * args[0].shape[1], args[0].shape[-1], \
            args[7].shape[0]
        return 2 * M * c * c + 4 * M * c * h, nbytes(*args) + M * c * 2
    if name == "packed_attention_bwd":
        qkv, bias, mask, g, stats = args[:5]
        flops = 10 * 64 * qkv.shape[1] * bias.shape[0] * _valid_keys(mask)
        return flops, 2 * nbytes(qkv, bias) + nbytes(mask, g, stats)
    if name == "mlp":
        M, c, h = args[0].shape[0] * args[0].shape[1], args[0].shape[-1], \
            args[1].shape[0]
        return 4 * M * c * h, nbytes(*args) + M * c * 2
    if name == "ln_linear_i8":
        x, wq = args[0], args[3]
        M, c, O = x.shape[0] * x.shape[1], x.shape[-1], wq.shape[0]
        return 0, nbytes(*args) + M * O * 2, 2 * M * c * O
    if name == "proj_mlp_tail_i8":
        M, c, h = args[0].shape[0] * args[0].shape[1], args[0].shape[-1], \
            args[8].shape[0]
        tensors = [t for t in args if isinstance(t, torch.Tensor)]
        return 0, nbytes(*tensors) + M * c * 2, 2 * M * c * c + 4 * M * c * h
    if name == "linear_residual":
        x, w = args[:2]
        M, O = x.shape[0] * x.shape[1], w.shape[0]
        return 2 * M * x.shape[-1] * O, nbytes(*args) + M * O * 2
    if name == "mlp_tail":
        M, c, h = args[0].shape[0] * args[0].shape[1], args[0].shape[-1], \
            args[3].shape[0]
        return 4 * M * c * h, nbytes(*args) + M * c * 2
    if name in ("ln_qkv_attention", "block_eval"):
        x, mask, heads = args[0], args[6], args[8]
        M, n, c = x.shape[0] * x.shape[1], x.shape[1], x.shape[2]
        flops = 2 * M * c * 3 * c + 4 * 64 * n * heads * _valid_keys(mask)
        if name == "block_eval":
            flops += 2 * M * c * c + 4 * M * c * args[14].shape[0]
        tensors = [t for t in args if isinstance(t, torch.Tensor)]
        return flops, nbytes(*tensors) + M * c * 2
    if name == "packed_attention_i8qk":
        qkv, bias, mask = args[:3]
        pairs = 2 * 64 * N * HEADS * _valid_keys(mask)   # QKᵀ int8, P·V bf16
        return pairs, nbytes(qkv, bias, mask) + qkv.numel() // 3 * 2, pairs
    raise KeyError(name)


def _sdpa_args(qkv, bias, mask):
    """q, k, v (B, H, N, d) views of the packed qkv and the additive mask
    (B, H, N, N) bf16: the bias with masked keys (mask <= 0, the kernels'
    rule) at -inf."""
    B, n, heads = qkv.shape[0], qkv.shape[1], bias.shape[0]
    q, k, v = qkv.view(B, n, 3, heads, 64).permute(2, 0, 3, 1, 4)
    am = bias[None] + torch.zeros_like(mask, dtype=torch.float32).masked_fill(
        mask <= 0, float("-inf"))[:, None, None, :]
    return q, k, v, am.to(qkv.dtype)


def library_call(name: str, args):
    """One PyTorch call computing the same function, as a yardstick (the
    port never calls it), or None where there is none: LN+linear (K1), the
    fused proj/MLP tail (K3, K6) and fc1+gelu+fc2 (K13) take several
    calls.  For K2, K10 and K11: SDPA with the bias and the key mask as
    one additive bf16 mask."""
    if name == "packed_attention":
        q, k, v, am = _sdpa_args(*args[:3])
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                      scale=args[3])
    if name in ("split_attention", "split_attention_bb"):
        q, k, v, bias, mask, scale = args
        am = (bias[None] + torch.zeros_like(mask, dtype=torch.float32)
              .masked_fill(mask <= 0, float("-inf"))[:, None, None, :])
        am = am.to(q.dtype)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                      scale=scale)
    if name == "packed_attention_bwd":
        qkv, bias, mask, g = args[:4]
        q, k, v, am = (t.detach().requires_grad_()
                       for t in _sdpa_args(qkv, bias, mask))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                             scale=args[5])
        gh = g.view(*g.shape[:2], bias.shape[0], 64).transpose(1, 2)
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
                         "vl_merging_tpu_torch/csrc/packed_attention_fwd.cu",
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
    "ln_linear_i8": (i8_ops.ln_linear_i8, i8_ops.ref_ln_linear_i8,
                     "vl_merging_tpu_torch/csrc/ln_linear_i8.cu",
                     "vl_merging_tpu/ops/int8.py:154"),
    "proj_mlp_tail_i8": (i8_ops.proj_mlp_tail_i8,
                         i8_ops.ref_proj_mlp_tail_i8,
                         "vl_merging_tpu_torch/csrc/proj_mlp_tail_i8.cu",
                         "vl_merging_tpu/ops/int8.py:164"),
    "packed_attention_i8qk": (attn_ops.packed_attention_i8qk,
                              attn_ops.packed_attention_i8qk_reference,
                              "vl_merging_tpu_torch/csrc/"
                              "packed_attention_i8qk.cu",
                              "vl_merging_tpu/ops/attention.py:271"),
    "linear_residual": (fb_ops.linear_residual,
                        fb_ops.linear_residual_reference,
                        "vl_merging_tpu_torch/csrc/linear_residual.cu",
                        "vl_merging_tpu/ops/fused_block.py:94"),
    "mlp_tail": (fb_ops.mlp_tail, fb_ops.mlp_tail_reference,
                 "vl_merging_tpu_torch/csrc/mlp_tail.cu",
                 "vl_merging_tpu/ops/fused_block.py:102"),
    "ln_qkv_attention": (fb_ops.ln_qkv_attention,
                         fb_ops.ln_qkv_attention_reference,
                         "vl_merging_tpu_torch/csrc/ln_qkv_attention.cu",
                         "vl_merging_tpu/ops/attention.py:384"),
    "block_eval": (fb_ops.block_eval, fb_ops.block_eval_reference,
                   "vl_merging_tpu_torch/csrc/block_eval.cu",
                   "vl_merging_tpu/ops/fused_block.py:471"),
    "split_attention": (attn_ops.split_attention,
                        attn_ops.split_attention_reference,
                        "vl_merging_tpu_torch/csrc/split_attention.cu",
                        "vl_merging_tpu/ops/attention.py:89"),
    "split_attention_bb": (attn_ops.split_attention_bb,
                           attn_ops.split_attention_reference,
                           "vl_merging_tpu_torch/csrc/split_attention.cu",
                           "vl_merging_tpu/ops/attention.py:111"),
    "tail_train": (fb_ops.tail_train, fb_ops.tail_train_reference,
                   "vl_merging_tpu_torch/csrc/tail_train.cu",
                   "vl_merging_tpu/ops/fused_block.py:327"),
}
# the int8 kernels' bf16 counterparts, timed at the same shapes
BF16_TWIN = {"ln_linear_i8": "ln_linear", "proj_mlp_tail_i8": "proj_mlp_tail",
             "packed_attention_i8qk": "packed_attention"}


def split_timing(inputs, rows: dict, card: str) -> None:
    """K10 (B=6) and K11 (B=32) at N=197, 12 heads, on the views of a
    packed qkv: the kernel's device time alone (``device_ms``: a CUDA
    graph) beside its per-call time (``time_ms``: the wrapper's host path
    between launches), SDPA's both ways, each pair in turns; the wrappers'
    host µs per call beside K2's, in turns; the two bars, met or
    missed."""
    k2_args = inputs["packed_attention"]
    label = {"split_attention": "K10", "split_attention_bb": "K11"}
    for name in ("split_attention", "split_attention_bb"):
        args, kernel = inputs[name], KERNELS[name][0]
        sdpa = library_call(name, args)
        dev_ms, sdpa_dev = in_turns(lambda: kernel(*args), sdpa, device_ms)
        call_ms, sdpa_call = in_turns(lambda: kernel(*args), sdpa)
        us, k2_us = in_turns(lambda: kernel(*args),
                             lambda: attn_ops.packed_attention(*k2_args),
                             host_us)
        rows[name].update(device_ms=dev_ms, library_device_ms=sdpa_dev,
                          host_us=us)
        if name == "split_attention_bb":
            bar = (f"bar: device <= {K11_BAR_MS} ms "
                   f"{'met' if dev_ms <= K11_BAR_MS else 'missed'}")
        else:
            bar = (f"bar: device below SDPA's "
                   f"{'met' if dev_ms < sdpa_dev else 'missed'}")
        print(f"{label[name]} ({name}) at {'x'.join(map(str, args[0].shape))}"
              f": device {dev_ms:.4f} ms (a graph of {GRAPH_LAUNCHES}), per "
              f"call {call_ms:.4f} ms; SDPA device {sdpa_dev:.4f} ms, per "
              f"call {sdpa_call:.4f} ms (each pair in turns); wrapper host "
              f"{us:.2f} us a call (K2's at B={k2_args[0].shape[0]}, "
              f"N={N}, in turns: {k2_us:.2f}); {bar} [{card}]")


def ulp_check(name: str, got, want) -> tuple:
    """(max |kernel - twin|, worst error as a share of the bound, share of
    elements that differ at all)."""
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    worst = float((err / (ULPS[name] * BF16_ULP * (ref + ref.mean()))).max())
    return float(err.max()), worst, float((err > 0).float().mean())


def differ_share(a, b) -> float:
    return float((a.float() != b.float()).float().mean())


def staged_comparisons(inputs, card: str) -> None:
    """The fusion kernels against the staged kernels they replace, on the
    same inputs: output (bit-equal or not, share of elements that differ)
    and time."""
    ctx, wp, bp, g1, res, ln2_w, ln2_b, w1, b1, w2, b2, g2 = \
        inputs["proj_mlp_tail"]
    x, ln1_w, ln1_b, w_qkv, qkv_bias, bias, mask, scale, heads = \
        inputs["ln_qkv_attention"]

    def k1_k2():
        qkv = fb_ops.ln_linear(x, ln1_w, ln1_b, w_qkv, qkv_bias)
        return attn_ops.packed_attention(qkv, bias, mask, scale, heads)

    def k1_k2_k3():
        return fb_ops.proj_mlp_tail(k1_k2(), wp, bp, g1, x, ln2_w, ln2_b, w1,
                                    b1, w2, b2, g2)

    def k8_k3():
        return fb_ops.proj_mlp_tail(
            fb_ops.ln_qkv_attention(*inputs["ln_qkv_attention"]), wp, bp, g1,
            x, ln2_w, ln2_b, w1, b1, w2, b2, g2)

    def k4_k5():
        return fb_ops.mlp_tail(fb_ops.linear_residual(ctx, wp, bp, g1, res),
                               ln2_w, ln2_b, w1, b1, w2, b2, g2)

    def k7():
        return fb_ops.block_eval(*inputs["block_eval"])

    cases = (
        ("K4 -> K5 vs K3", k4_k5, "K3", lambda: fb_ops.proj_mlp_tail(
            ctx, wp, bp, g1, res, ln2_w, ln2_b, w1, b1, w2, b2, g2)),
        ("K8 vs K1 -> K2",
         lambda: fb_ops.ln_qkv_attention(*inputs["ln_qkv_attention"]),
         "K1 + K2", k1_k2),
        ("K7 vs K8 -> K3", k7, "K8 + K3", k8_k3),
        ("K7 vs K1 -> K2 -> K3", k7, "K1 + K2 + K3", k1_k2_k3))
    split = inputs["split_attention_bb"]
    sq, sk, sv, sbias, smask, sscale = split
    sB = sq.shape[0]
    # the packed qkv whose views K10 and K11 read (q starts it)
    qkv = sq.as_strided((sB, N_224, 3 * C), (N_224 * 3 * C, 3 * C, 1))
    six = (sq[:K10_BATCH], sk[:K10_BATCH], sv[:K10_BATCH], sbias,
           smask[:K10_BATCH], sscale)
    u1, u2 = (g.bfloat16().float() for g in (g1, g2))
    B = ctx.shape[0]
    cases += (
        ("K10 vs K11 (B=32, N=197)",
         lambda: attn_ops.split_attention(*split), "K11",
         lambda: attn_ops.split_attention_bb(*split)),
        (f"K10 at B={K10_BATCH} vs K11's first {K10_BATCH} (B=32, N=197)",
         lambda: attn_ops.split_attention(*six), "K11",
         lambda: attn_ops.split_attention_bb(*split)[:K10_BATCH]),
        ("K10 vs K2 (packed qkv, N=197)",
         lambda: attn_ops.split_attention(*split).transpose(1, 2).reshape(
             sB, N_224, C), "K2",
         lambda: attn_ops.packed_attention(qkv, sbias, smask, sscale,
                                           HEADS)),
        ("K6 at uniform gammas vs K3",
         lambda: fb_ops.tail_train(ctx, wp, bp, u1.expand(B, 1, C), res,
                                   ln2_w, ln2_b, w1, b1, w2, b2,
                                   u2.expand(B, 1, C)),
         "K3", lambda: fb_ops.proj_mlp_tail(ctx, wp, bp, u1, res, ln2_w,
                                            ln2_b, w1, b1, w2, b2, u2)))
    # bit-equal by construction: the shared MLP body (K4 -> K5, K6), and K7
    # and K8, which run K1's and K2's device code (K7 the MLP body's too),
    # and K10 and K11, which run K2's
    bit_equal = ("K4 -> K5 vs K3", "K6 at uniform gammas vs K3",
                 "K8 vs K1 -> K2", "K7 vs K8 -> K3", "K7 vs K1 -> K2 -> K3",
                 "K10 vs K11 (B=32, N=197)",
                 f"K10 at B={K10_BATCH} vs K11's first {K10_BATCH} (B=32, "
                 f"N=197)", "K10 vs K2 (packed qkv, N=197)")
    # the bars of the fused kernels' time against the staged kernels'
    bars = {"K7 vs K1 -> K2 -> K3": K7_BAR, "K8 vs K1 -> K2": K8_BAR}
    for label, fused, staged_name, staged in cases:
        got, want = fused(), staged()
        torch.cuda.synchronize()
        if label in bit_equal and not torch.equal(got, want):
            fail(f"{label}: not bit-equal")
        fused_ms, staged_ms = in_turns(fused, staged)
        bar = ""
        if label in bars:
            bar = (f"; {fused_ms / staged_ms:.3f} x (bar {bars[label]}: "
                   f"{'met' if fused_ms <= bars[label] * staged_ms else 'missed'})")
        print(f"{label}: bit-equal {torch.equal(got, want)}, "
              f"{differ_share(got, want):.3e} of the elements differ; "
              f"{fused_ms:.4f} ms against {staged_name} "
              f"{staged_ms:.4f} ms at the same shapes, in turns{bar} "
              f"[{card}]")


def linear_yardstick_ms(args) -> float:
    """One cuBLAS ``F.linear`` on K1's rows already normalised to bf16:
    what K1's product alone costs on this card (the port never calls
    it)."""
    x, lw, lb, w, _ = args
    xn = layer_norm(x, lw, lb, eps=fb_ops.LN_EPS)
    return time_ms(lambda: F.linear(xn, w))


# the kernels whose output bits ``--digests`` prints (K2, K7, K8, K10, K11,
# K12, K14, K15): ``chip_profile.py --digests TREE`` sets them beside
# another tree's
DIGESTED = ("packed_attention", "block_eval", "ln_qkv_attention",
            "split_attention", "split_attention_bb", "packed_attention_i8qk",
            "ln_linear_i8", "proj_mlp_tail_i8")


def digest_inputs(dev) -> dict:
    """Phase 3's seeded inputs, the fused kernels' among them."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    inputs = kernel_inputs(dev, gen)
    inputs.update(fusion_inputs(inputs))
    return inputs


def digest(kernel, args) -> str:
    """The SHA-256 of the bits of ``kernel``'s output on ``args``."""
    y = kernel(*args)
    return hashlib.sha256(y.view(torch.int16).cpu().numpy().tobytes()
                          ).hexdigest()


def check_k14(args) -> None:
    """K14's units and rounds at these shapes, the SHA-256 of its output
    (the same bits as every earlier K14 design: the products are exact and
    the LN, quantizer and dequant code unchanged), and two launches
    bit-equal."""
    x, wq = args[0], args[3]
    M, O = x.shape[0] * x.shape[1], wq.shape[0]
    grid = i8_ops.ln_linear_i8_grid(x.shape[-1])
    units, rounds = i8_ops.ln_linear_i8_plan(M, O, grid)
    got = digest(i8_ops.ln_linear_i8, args)
    print(f"ln_linear_i8 at C={x.shape[-1]}: {units} units on {grid // 2} "
          f"clusters of two, {rounds} rounds of column tiles; output sha256 "
          f"on phase 3's seeded inputs {got}")
    if digest(i8_ops.ln_linear_i8, args) != got:
        fail("ln_linear_i8: two launches differ")


def k12_against_k2(args) -> tuple:
    """K12 and K2 on the same inputs, in turns (K12, K2, K2, K12, the best
    of each): K12's time as printed, K2's, and K12's bar, met or
    missed."""
    k12, k2 = in_turns(lambda: attn_ops.packed_attention_i8qk(*args),
                       lambda: attn_ops.packed_attention(*args))
    return (f" (in turns: {k12:.4f})", k2,
            f"; {k12 / k2:.3f} x (bar {K12_BAR:.2f}: "
            f"{'met' if k12 <= K12_BAR * k2 else 'missed'})")


def check_i8_gelus(args) -> None:
    """The SHA-256 of K15's output on ``args``, printed; K15 with each gelu
    of ``ops/mlp.GELUS`` against its twin, within its 4 ulps, a row of
    context all zero (its quantizer's amax floor) among them."""
    print(f"proj_mlp_tail_i8 at C={args[0].shape[-1]}: output sha256 on "
          f"phase 3's seeded inputs {digest(i8_ops.proj_mlp_tail_i8, args)}")
    args = list(args)
    args[0] = args[0].clone()
    args[0][0, 0] = 0
    width = args[0].shape[-1]
    for gelu in mlp_ops.GELUS:
        got = i8_ops.proj_mlp_tail_i8(*args, gelu=gelu)
        want = i8_ops.ref_proj_mlp_tail_i8(*args, gelu=gelu)
        torch.cuda.synchronize()
        max_err, worst, differ = ulp_check("proj_mlp_tail_i8", got, want)
        print(f"proj_mlp_tail_i8 at C={width}, gelu {gelu!r}, a zero context "
              f"row: max |kernel - twin| = {max_err:.6g}, worst err/bound = "
              f"{worst:.3f}, {differ:.3e} of the elements differ")
        if not bool(torch.isfinite(got).all()) or worst > 1.0:
            fail(f"proj_mlp_tail_i8 at C={width} with gelu {gelu!r} disagrees "
                 f"with its twin")


def check_kernels(dev, card: str, usage: dict) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    inputs = kernel_inputs(dev, gen)
    inputs.update(fusion_inputs(inputs))
    inputs.update(train_fusion_inputs(inputs, gen))
    rows = {}
    for name, (kernel, twin, source, replaces) in KERNELS.items():
        args = inputs[name]
        twin_args = plain_args(name, args)
        if name == "packed_attention_bwd":
            # fault C8: D = Σ_k dp ⊙ p in f32, not the context's Σ g ⊙ o, so
            # that the twin fed the plain forward is the plain backward
            # throughout: gated
            max_err = check_backward(args, twin(*twin_args),
                                     " (C8: its twin fed the plain forward, "
                                     "D = Σ_k dp ⊙ p)")
        else:
            got, want = kernel(*args), twin(*twin_args)
            torch.cuda.synchronize()
            max_err, worst, differ = ulp_check(name, got, want)
            print(f"{name}: max |kernel - twin| = {max_err:.6g}, worst "
                  f"err/bound = {worst:.3f} (bound {ULPS[name]} bf16 ulps), "
                  f"{differ:.3e} of the elements differ")
            if not bool(torch.isfinite(got).all()) or worst > 1.0:
                fail(f"{name} disagrees with its plain twin")
        ms = time_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: twin(*twin_args), iters=TIMED_ITERS // 2)
        lib = library_call(name, args)
        library_ms = None if lib is None else time_ms(lib)
        bound_ms, bound_by = bound(*work(name, args))
        shape = "x".join(map(str, args[0].shape))
        if name in BF16_TWIN:
            twin_ms, turns = rows[BF16_TWIN[name]]['ms'], ""
            bar = ""
            if name == "ln_linear_i8":
                k1_args = inputs["ln_linear"]
                ms_t, twin_ms = in_turns(lambda: kernel(*args),
                                         lambda: fb_ops.ln_linear(*k1_args))
                turns = f" (in turns: {ms_t:.4f})"
                bar = (f"; {ms_t / twin_ms:.3f} x (bar {K14_BAR}: "
                       f"{'met' if ms_t <= K14_BAR * twin_ms else 'missed'})")
                check_k14(args)
            if name == "proj_mlp_tail_i8":
                bar = (f"; {ms / twin_ms:.3f} x (bar {K15_BAR}: "
                       f"{'met' if ms <= K15_BAR * twin_ms else 'missed'})")
            if name == "packed_attention_i8qk":
                turns, twin_ms, bar = k12_against_k2(inputs["packed_attention"])
                print(f"packed_attention_i8qk: output sha256 on phase 3's "
                      f"seeded inputs {digest(kernel, args)}")
            print(f"{name}: {ms:.4f} ms{turns} against {BF16_TWIN[name]} "
                  f"{twin_ms:.4f} ms at the same shapes{bar} [{card}]")
        if name == "proj_mlp_tail_i8":
            check_i8_gelus(args)
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              + ("none (no single PyTorch call computes it)"
                 if library_ms is None else f"{library_ms:.4f} ms")
              + f", bound {bound_ms:.4f} ms ({bound_by}) at {shape} bf16"
              + (f"; {usage[name]}" if name in usage else "") + f" [{card}]")
        if name == "ln_linear":
            print(f"ln_linear: yardstick F.linear (cuBLAS) on the "
                  f"pre-normalised bf16 rows {linear_yardstick_ms(args):.4f} "
                  f"ms at {shape} [{card}]")
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": 0,
                      "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms}
    # K13 also runs on the eval's text blocks: 64 captions x 40 tokens
    args = (inputs["mlp"][0].reshape(-1, C)[:TEXT_BATCH * 40].reshape(
        TEXT_BATCH, 40, C), *inputs["mlp"][1:])
    max_err, worst, _ = ulp_check("mlp", mlp_ops.mlp_kernel(*args),
                                  mlp_ops.mlp_kernel_reference(*args))
    print(f"mlp at 64x40 rows: max |kernel - twin| = {max_err:.6g}, worst "
          f"err/bound = {worst:.3f}, kernel "
          f"{time_ms(lambda: mlp_ops.mlp_kernel(*args)):.4f} ms, bound "
          f"{bound(*work('mlp', args))[0]:.4f} ms [{card}]")
    if worst > 1.0:
        fail("mlp disagrees with its plain twin at the text tower's rows")
    # K1 also runs on the training text blocks under "full": 32 x 40 rows
    args = (inputs["ln_linear"][0].reshape(-1, C)[:MICRO_BATCH * 40].reshape(
        MICRO_BATCH, 40, C), *inputs["ln_linear"][1:])
    max_err, worst, _ = ulp_check("ln_linear", fb_ops.ln_linear(*args),
                                  fb_ops.ln_linear_reference(*args))
    print(f"ln_linear at 32x40 rows: max |kernel - twin| = {max_err:.6g}, "
          f"worst err/bound = {worst:.3f}, kernel "
          f"{time_ms(lambda: fb_ops.ln_linear(*args)):.4f} ms, yardstick "
          f"F.linear {linear_yardstick_ms(args):.4f} ms, bound "
          f"{bound(*work('ln_linear', args))[0]:.4f} ms [{card}]")
    if worst > 1.0:
        fail("ln_linear disagrees with its plain twin at the text rows")
    # K6 also runs on the training text blocks: 32 captions x 40 tokens
    args = [t.reshape(-1, C)[:MICRO_BATCH * 40].reshape(MICRO_BATCH, 40, C)
            if t.dim() == 3 and t.shape[1] == N else t
            for t in inputs["tail_train"]]
    max_err, worst, _ = ulp_check("tail_train", fb_ops.tail_train(*args),
                                  fb_ops.tail_train_reference(*args))
    print(f"tail_train at 32x40 rows: max |kernel - twin| = {max_err:.6g}, "
          f"worst err/bound = {worst:.3f}, kernel "
          f"{time_ms(lambda: fb_ops.tail_train(*args)):.4f} ms, bound "
          f"{bound(*work('tail_train', args))[0]:.4f} ms [{card}]")
    if worst > 1.0:
        fail("tail_train disagrees with its plain twin at the text rows")
    split_timing(inputs, rows, card)
    # K2's training launch stores each query row's softmax statistics for K9
    rows["packed_attention"]["train_ms"] = check_training_attention(
        inputs["packed_attention_bwd"], card)
    check_joint_backward(dev, gen, rows, card)
    for row in rows.values():
        row["widths"] = [C]
    check_wide_kernels(dev, gen, rows, card)
    staged_comparisons(inputs, card)
    # a note, not a yardstick: torch's int8 GEMM alone at K14's GEMM shape
    x = inputs["ln_linear_i8"][0].reshape(-1, C)
    xq = attn_ops.quant_rows(x.float())[0]
    wt = inputs["ln_linear_i8"][3].t()
    note = (f"{time_ms(lambda: torch._int_mm(xq, wt)):.4f} ms"
            if hasattr(torch, "_int_mm") else "not available")
    print(f"note: torch._int_mm (s8 {tuple(xq.shape)} @ s8 "
          f"{tuple(wt.shape)} -> s32, the GEMM of K14 without its LN, "
          f"quantizer and epilogue): {note} [{card}]")
    return rows


def wide_inputs(dev, gen):
    """The main-path shapes of the ViT-L width: one image block of the eval
    at B=32 (577 tokens, C=1024, MLP 4096), and K6 at a training
    micro-batch of 8 with drawn stochastic-depth gammas."""
    B, c, h = IMAGE_BATCH, C_L, HIDDEN_L

    def r(*shape, s=1.0, bf16=False, shift=0.0):
        t = shift + s * torch.randn(*shape, device=dev, generator=gen)
        return t.bfloat16() if bf16 else t

    x, res = r(B, N, c, bf16=True), r(B, N, c, bf16=True)
    wp, bp, g1 = r(c, c, s=0.02, bf16=True), r(c, s=0.1), r(c, s=0.1)
    lw, lb = r(c, s=0.1, shift=1.0), r(c, s=0.1)
    w1, b1 = r(h, c, s=0.02, bf16=True), r(h, s=0.1)
    w2, b2, g2 = r(c, h, s=0.02, bf16=True), r(c, s=0.1), r(c, s=0.1)
    dp = (torch.rand(2, L_MICRO, device=dev, generator=gen) < 0.9).float() \
        / 0.9
    ge1, ge2 = (dp[i][:, None, None].bfloat16() * g.bfloat16()
                for i, g in enumerate((g1, g2)))
    xt, rt = x[:L_MICRO], res[:L_MICRO]
    return {
        "ln_linear": (x, lw, lb, r(3 * c, c, s=0.02, bf16=True),
                      r(3 * c, s=0.1)),
        "proj_mlp_tail": (x, wp, bp, g1, res, lw, lb, w1, b1, w2, b2, g2),
        "mlp": (x, w1, b1, w2, b2),
        "tail_train": (xt, wp, bp, ge1, rt, lw, lb, w1, b1, w2, b2, ge2),
        "linear_residual": (x, wp, bp, g1, res),
        "mlp_tail": (res, lw, lb, w1, b1, w2, b2, g2)}


def check_wide_kernels(dev, gen, rows, card: str) -> None:
    """K1, K3, K13, K6, K4 and K5 against their twins at the ViT-L width,
    with their tolerance at 768; their times beside the bound; the
    bit-equalities of the shared MLP body at 1024 (K4 -> K5 and K6 at
    uniform gammas against K3)."""
    inputs = wide_inputs(dev, gen)
    for name in WIDE:
        kernel, twin = KERNELS[name][:2]
        args = inputs[name]
        got, want = kernel(*args), twin(*args)
        torch.cuda.synchronize()
        max_err, worst, differ = ulp_check(name, got, want)
        ms = time_ms(lambda: kernel(*args))
        bound_ms, bound_by = bound(*work(name, args))
        shape = "x".join(map(str, args[0].shape))
        print(f"{name} at C={C_L}: max |kernel - twin| = {max_err:.6g}, worst "
              f"err/bound = {worst:.3f} (bound {ULPS[name]} bf16 ulps), "
              f"{differ:.3e} of the elements differ; kernel {ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}) at {shape} bf16 [{card}]")
        if name == "ln_linear":
            print(f"ln_linear at C={C_L}: yardstick F.linear (cuBLAS) on the "
                  f"pre-normalised bf16 rows {linear_yardstick_ms(args):.4f} "
                  f"ms [{card}]")
        if not bool(torch.isfinite(got).all()) or worst > 1.0:
            fail(f"{name} disagrees with its plain twin at C={C_L}")
        rows[name]["widths"].append(C_L)
        rows[name][f"at_{C_L}"] = {"max_abs_err": max_err, "ms": ms,
                                   "bound_ms": bound_ms,
                                   "bound_by": bound_by}
    ctx, wp, bp, g1, res, lw, lb, w1, b1, w2, b2, g2 = \
        inputs["proj_mlp_tail"]
    u1, u2 = (g.bfloat16().float() for g in (g1, g2))
    k3 = fb_ops.proj_mlp_tail(ctx, wp, bp, u1, res, lw, lb, w1, b1, w2, b2,
                              u2)
    k45 = fb_ops.mlp_tail(fb_ops.linear_residual(ctx, wp, bp, u1, res), lw,
                          lb, w1, b1, w2, b2, u2)
    B = ctx.shape[0]
    k6 = fb_ops.tail_train(ctx, wp, bp, u1.expand(B, 1, C_L), res, lw, lb,
                           w1, b1, w2, b2, u2.expand(B, 1, C_L))
    torch.cuda.synchronize()
    print(f"at C={C_L}: K4 -> K5 vs K3 bit-equal {torch.equal(k45, k3)}, "
          f"{differ_share(k45, k3):.3e} of the elements differ; K6 at "
          f"uniform gammas vs K3 bit-equal {torch.equal(k6, k3)}, "
          f"{differ_share(k6, k3):.3e} differ")
    if not (torch.equal(k45, k3) and torch.equal(k6, k3)):
        fail(f"the shared MLP body's bit-equalities fail at C={C_L}")
    check_wide_attention(dev, gen, rows, card)
    check_wide_k8(dev, gen, rows, card)
    check_wide_fused(dev, gen, rows, card)


def check_wide_attention(dev, gen, rows, card: str) -> None:
    """K2 at the ViT-L eval shape (B=32, N=577, 16 heads) against its
    twin, with its 4 ulps; eval and training launch timed beside SDPA and
    the bound; K12 on the same inputs against its twin, timed in turns
    with K2 (its bar) and beside its bound."""
    qkv = torch.randn(IMAGE_BATCH, N, 3 * C_L, device=dev,
                      generator=gen).bfloat16()
    bias = torch.randn(HEADS_L, N, N, device=dev, generator=gen)
    mask = torch.ones(IMAGE_BATCH, N, dtype=torch.int32, device=dev)
    mask[-1, 500:] = 0
    args = (qkv, bias, mask, 64 ** -0.5, HEADS_L)
    got = attn_ops.packed_attention(*args)
    want = attn_ops.packed_attention_reference(*args)
    torch.cuda.synchronize()
    max_err, worst, differ = ulp_check("packed_attention", got, want)
    ms = time_ms(lambda: attn_ops.packed_attention(*args))
    train_ms = time_ms(lambda: attn_ops.packed_attention(*args,
                                                         with_stats=True))
    library_ms = time_ms(library_call("packed_attention", args))
    bound_ms, bound_by = bound(*work("packed_attention", args))
    print(f"packed_attention at {HEADS_L} heads (C={C_L}): max |kernel - "
          f"twin| = {max_err:.6g}, worst err/bound = {worst:.3f} (bound "
          f"{ULPS['packed_attention']} bf16 ulps), {differ:.3e} of the "
          f"elements differ; kernel {ms:.4f} ms, training launch "
          f"{train_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by}) [{card}]")
    if not bool(torch.isfinite(got).all()) or worst > 1.0:
        fail(f"packed_attention disagrees with its plain twin at "
             f"{HEADS_L} heads")
    rows["packed_attention"]["widths"].append(C_L)
    rows["packed_attention"][f"at_{C_L}"] = {
        "max_abs_err": max_err, "ms": ms, "train_ms": train_ms,
        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    # K12 on the same inputs: against its twin, and in turns with K2
    name = "packed_attention_i8qk"
    got = attn_ops.packed_attention_i8qk(*args)
    want = attn_ops.packed_attention_i8qk_reference(*args)
    torch.cuda.synchronize()
    max_err, worst, differ = ulp_check(name, got, want)
    ms = time_ms(lambda: attn_ops.packed_attention_i8qk(*args))
    plain_ms = time_ms(lambda: attn_ops.packed_attention_i8qk_reference(
        *args), iters=TIMED_ITERS // 2)
    bound_ms, bound_by = bound(*work(name, args))
    turns, k2_ms, bar = k12_against_k2(args)
    print(f"{name} at {HEADS_L} heads (C={C_L}): max |kernel - twin| = "
          f"{max_err:.6g}, worst err/bound = {worst:.3f} (bound {ULPS[name]} "
          f"bf16 ulps), {differ:.3e} of the elements differ; kernel "
          f"{ms:.4f} ms{turns} against packed_attention {k2_ms:.4f} ms at the "
          f"same shapes{bar}; plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by}) [{card}]")
    if not bool(torch.isfinite(got).all()) or worst > 1.0:
        fail(f"{name} disagrees with its plain twin at {HEADS_L} heads")
    rows[name]["widths"].append(C_L)
    rows[name][f"at_{C_L}"] = {
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by}


def check_wide_k8(dev, gen, rows, card: str) -> None:
    """K8 at the ViT-L width (B=32, N=577, C=1024, 16 heads) and at the
    @480 image tower's N=901 (C=768): against its twin with its 4 ulps and
    bit-equal to K1 -> K2; timed, in turns with K1 -> K2, beside its
    bound."""
    for c, heads, n in ((C_L, HEADS_L, N), (C, HEADS, 901)):
        def r(*shape, s=1.0, shift=0.0):
            return shift + s * torch.randn(*shape, device=dev, generator=gen)

        mask = torch.ones(IMAGE_BATCH, n, dtype=torch.int32, device=dev)
        mask[-1, n - 77:] = 0
        args = (r(IMAGE_BATCH, n, c).bfloat16(), r(c, s=0.1, shift=1.0),
                r(c, s=0.1), r(3 * c, c, s=0.02).bfloat16(), r(3 * c, s=0.1),
                r(heads, n, n), mask, 64 ** -0.5, heads)

        def staged():
            return attn_ops.packed_attention(fb_ops.ln_linear(*args[:5]),
                                             *args[5:])
        got, k1_k2 = fb_ops.ln_qkv_attention(*args), staged()
        want = fb_ops.ln_qkv_attention_reference(*args)
        torch.cuda.synchronize()
        max_err, worst, differ = ulp_check("ln_qkv_attention", got, want)
        same = torch.equal(got, k1_k2)
        ms, staged_ms = in_turns(lambda: fb_ops.ln_qkv_attention(*args),
                                 staged)
        bound_ms, bound_by = bound(*work("ln_qkv_attention", args))
        print(f"ln_qkv_attention at C={c}, {heads} heads, N={n}: max |kernel "
              f"- twin| = {max_err:.6g}, worst err/bound = {worst:.3f} "
              f"(bound {ULPS['ln_qkv_attention']} bf16 ulps), {differ:.3e} "
              f"of the elements differ; bit-equal to K1 -> K2 {same}; kernel "
              f"{ms:.4f} ms against K1 -> K2 {staged_ms:.4f} ms in turns "
              f"({ms / staged_ms:.3f} x), bound {bound_ms:.4f} ms "
              f"({bound_by}) [{card}]")
        if not bool(torch.isfinite(got).all()) or worst > 1.0:
            fail(f"ln_qkv_attention disagrees with its twin at C={c}, N={n}")
        if not same:
            fail(f"ln_qkv_attention is not bit-equal to K1 -> K2 at C={c}, "
                 f"N={n}")
        if c == C_L:
            rows["ln_qkv_attention"]["widths"].append(C_L)
            rows["ln_qkv_attention"][f"at_{C_L}"] = {
                "max_abs_err": max_err, "ms": ms, "staged_ms": staged_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}
        else:
            rows["ln_qkv_attention"][f"at_n{n}"] = {
                "max_abs_err": max_err, "ms": ms, "staged_ms": staged_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}


def wide_fused_inputs(dev, gen):
    """K14, K15 and K7 at the ViT-L eval shape (B=32, N=577, C=1024, 16
    heads, MLP 4096), and the staged kernels' inputs (K1, K3) made of the
    same tensors: K14 takes K1's x, LN and qkv bias with the int8 qkv
    weight, K15 K3's tensors with the int8 proj and MLP weights, K7 those
    of K1, K2 (a bias and a key mask) and K3."""
    B, c, h = IMAGE_BATCH, C_L, HIDDEN_L

    def r(*shape, s=1.0, bf16=False, shift=0.0):
        t = shift + s * torch.randn(*shape, device=dev, generator=gen)
        return t.bfloat16() if bf16 else t

    def q(w):   # an int8 weight and its per-channel scales
        return i8_ops.quantize_weight(w.float())

    mask = torch.ones(B, N, dtype=torch.int32, device=dev)
    mask[-1, 500:] = 0
    x, ctx = r(B, N, c, bf16=True), r(B, N, c, bf16=True)
    lw, lb = r(c, s=0.1, shift=1.0), r(c, s=0.1)
    wqkv, bqkv = r(3 * c, c, s=0.02, bf16=True), r(3 * c, s=0.1)
    wp, bp, g1 = r(c, c, s=0.02, bf16=True), r(c, s=0.1), r(c, s=0.1)
    lw2, lb2 = r(c, s=0.1, shift=1.0), r(c, s=0.1)
    w1, b1 = r(h, c, s=0.02, bf16=True), r(h, s=0.1)
    w2, b2, g2 = r(c, h, s=0.02, bf16=True), r(c, s=0.1), r(c, s=0.1)
    tail = (wp, bp, g1, x, lw2, lb2, w1, b1, w2, b2, g2)
    return {
        "ln_linear": (x, lw, lb, wqkv, bqkv),
        "proj_mlp_tail": (ctx, *tail),
        "ln_linear_i8": (x, lw, lb, *q(wqkv), bqkv),
        "proj_mlp_tail_i8": (ctx, *q(wp), bp, g1, x, lw2, lb2, *q(w1), b1,
                             *q(w2), b2, g2),
        "block_eval": (x, lw, lb, wqkv, bqkv, r(HEADS_L, N, N), mask,
                       64 ** -0.5, HEADS_L, wp, bp, g1, lw2, lb2, w1, b1, w2,
                       b2, g2)}


def check_wide_fused(dev, gen, rows, card: str) -> None:
    """K14, K15 and K7 at the ViT-L width (B=32, N=577, C=1024, 16 heads,
    MLP 4096) against their twins with their tolerance at 768 (K15 at
    every gelu); each timed in turns beside its staged yardstick at the
    same shapes (K14 beside K1, K15 beside K3, K7 beside K1 -> K2 -> K3)
    with its bar (printed, met or missed), its plain twin and its bound;
    K7 bit-equal to K1 -> K2 -> K3 and to K8 -> K3 there (a difference
    fails)."""
    inputs = wide_fused_inputs(dev, gen)
    x, lw, lb, wqkv, bqkv, bias, mask, scale, heads, wp, bp, g1, lw2, lb2, \
        w1, b1, w2, b2, g2 = inputs["block_eval"]
    tail = (wp, bp, g1, x, lw2, lb2, w1, b1, w2, b2, g2)

    def k1_k2_k3():
        qkv = fb_ops.ln_linear(x, lw, lb, wqkv, bqkv)
        ctx = attn_ops.packed_attention(qkv, bias, mask, scale, heads)
        return fb_ops.proj_mlp_tail(ctx, *tail)

    def k8_k3():
        return fb_ops.proj_mlp_tail(fb_ops.ln_qkv_attention(
            *inputs["block_eval"][:9]), *tail)

    staged = {
        "ln_linear_i8": ("K1", lambda: fb_ops.ln_linear(*inputs["ln_linear"]),
                         K14_BAR),
        "proj_mlp_tail_i8": ("K3", lambda: fb_ops.proj_mlp_tail(
            *inputs["proj_mlp_tail"]), K15_BAR),
        "block_eval": ("K1 + K2 + K3", k1_k2_k3, K7_BAR)}
    for name, (yardstick, staged_fn, bar) in staged.items():
        kernel, twin = KERNELS[name][:2]
        args = inputs[name]
        got, want = kernel(*args), twin(*args)
        torch.cuda.synchronize()
        max_err, worst, differ = ulp_check(name, got, want)
        ms, staged_ms = in_turns(lambda: kernel(*args), staged_fn)
        plain_ms = time_ms(lambda: twin(*args), iters=TIMED_ITERS // 2)
        bound_ms, bound_by = bound(*work(name, args))
        met = ms <= bar * staged_ms
        print(f"{name} at C={C_L}: max |kernel - twin| = {max_err:.6g}, worst "
              f"err/bound = {worst:.3f} (bound {ULPS[name]} bf16 ulps), "
              f"{differ:.3e} of the elements differ; kernel {ms:.4f} ms "
              f"against {yardstick} {staged_ms:.4f} ms in turns, "
              f"{ms / staged_ms:.3f} x (bar {bar}: "
              f"{'met' if met else 'missed'}); plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}) at "
              f"{'x'.join(map(str, args[0].shape))} [{card}]")
        if not bool(torch.isfinite(got).all()) or worst > 1.0:
            fail(f"{name} disagrees with its plain twin at C={C_L}")
        rows[name]["widths"].append(C_L)
        rows[name][f"at_{C_L}"] = {
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "staged_ms": staged_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}
        if name == "ln_linear_i8":
            check_k14(args)
        if name == "proj_mlp_tail_i8":
            check_i8_gelus(args)
    k7 = fb_ops.block_eval(*inputs["block_eval"])
    staged_k7, k8 = k1_k2_k3(), k8_k3()
    torch.cuda.synchronize()
    print(f"at C={C_L}: K7 vs K1 -> K2 -> K3 bit-equal "
          f"{torch.equal(k7, staged_k7)}, {differ_share(k7, staged_k7):.3e} "
          f"of the elements differ; K7 vs K8 -> K3 bit-equal "
          f"{torch.equal(k7, k8)}, {differ_share(k7, k8):.3e} differ")
    if not (torch.equal(k7, staged_k7) and torch.equal(k7, k8)):
        fail(f"block_eval is not bit-equal to the staged kernels at C={C_L}")


def reset_launches() -> None:
    for kernel, *_ in KERNELS.values():
        kernel.launches = 0
    for kernel in BY_LENGTH.values():
        kernel.launches_at.clear()


def read_launches() -> dict:
    return {name: k.launches for name, (k, *_r) in KERNELS.items()}


# the wrappers that also count their launches by sequence length
BY_LENGTH = {"packed_attention": attn_ops.packed_attention,
             "packed_attention_bwd": attn_ops.packed_attention_bwd}


def read_launches_at() -> dict:
    """K2's and K9's launches by sequence length: {(name, N): count}."""
    return {(name, n): c for name, k in BY_LENGTH.items()
            for n, c in sorted(k.launches_at.items()) if c}


def want_launches(**counts) -> dict:
    """Every kernel's expected launches: the given counts, 0 elsewhere."""
    return {name: counts.get(name, 0) for name in KERNELS}


def block_launches(tokens: int, batch: int, blocks: int, fusion: str = "0",
                   train: bool = True,
                   int8: bool = False) -> collections.Counter:
    """The launches of ``blocks`` blocks over ``batch`` sequences of
    ``tokens`` tokens as the routing gives them, K2's and K9's also by
    length ((name, tokens)).  Training: K2 forward and K9 backward at
    KERNEL_MIN_N tokens or more, else K11 (batch a multiple of SPLIT_BB)
    or K10 forward at SPLIT_MIN_N or more; the MLP through K13 at "0"
    (MLP_MIN_ROWS rows or more), the post-attention half through K6 under
    "tail" and "full", LN1 + qkv through K1 under "full".  Eval: at
    KERNEL_MIN_N tokens or more the kernels of ``ROUTE_KERNELS[fusion]``
    (K14, K2, K15 with ``int8``), below it the attention as in training
    and the MLP through K13."""
    out = collections.Counter()
    if tokens >= mome.KERNEL_MIN_N:
        names = ("packed_attention", "packed_attention_bwd") if train else \
            ("ln_linear_i8", "packed_attention", "proj_mlp_tail_i8") if \
            int8 else ROUTE_KERNELS[fusion]
        for name in names:
            out[name] += blocks
            if name in BY_LENGTH:
                out[(name, tokens)] += blocks
        if not train:
            return out
    elif tokens >= attn_ops.SPLIT_MIN_N:
        out["split_attention_bb" if batch % attn_ops.SPLIT_BB == 0
            else "split_attention"] += blocks
    if fusion == "0" or not train:
        out["mlp"] += blocks if batch * tokens >= mome.MLP_MIN_ROWS else 0
    else:
        out["tail_train"] += blocks
        out["ln_linear"] += blocks if fusion == "full" else 0
    return out


def composed_in_fused_pass(b) -> bool:
    """Whether a block runs a fused sequence composed, neither split nor
    whole: ln_moe's shallow blocks (per-half LayerNorms around the shared
    attention and MLP, ``mome._block_names`` None)."""
    return not mome.splits(b, VL) and mome._block_names(b, VL) is None


def fused_pass_launches(spec, batch: int, fusion: str = "0",
                        train: bool = True, int8: bool = False):
    """One fused pass: each split layer's text half (40 tokens) and image
    half, each whole layer's joint sequence, and each composed layer's
    (``composed_in_fused_pass``) shared attention over the joint sequence
    and its shared MLP over its rows, as in training."""
    split = sum(mome.splits(b, VL) for b in spec.blocks)
    composed = sum(composed_in_fused_pass(b) for b in spec.blocks)
    T, I = spec.max_text_len, spec.image_len
    route = dict(fusion=fusion, train=train, int8=int8)
    out = (block_launches(T, batch, split, **route)
           + block_launches(I, batch, split, **route)
           + block_launches(T + I, batch, spec.num_layers - split - composed,
                            **route)
           + block_launches(T + I, batch, composed))
    if not train:   # the composed layers' attention takes no backward
        for k in ("packed_attention_bwd", ("packed_attention_bwd", T + I)):
            out[k] -= block_launches(T + I, batch, composed)[k]
    return +out


def tower_launches(spec, tokens: int, batch: int, rerun: bool = False,
                   **route):
    """A tower over ``tokens`` tokens, with its vlffn re-run of the deep
    layers when ``rerun``."""
    deep = spec.num_layers - spec.vlffn_start_layer_index
    return block_launches(tokens, batch, spec.num_layers
                          + (deep if rerun else 0), **route)


def scaled(counts: collections.Counter, k: int) -> collections.Counter:
    return collections.Counter({n: c * k for n, c in counts.items()})


def launches_now() -> collections.Counter:
    """The launches since ``reset_launches``, by kernel and K2's and K9's
    also by length, as ``block_launches`` gives them."""
    out = collections.Counter(read_launches())
    out.update(read_launches_at())
    return +out


def check_launches(label: str, want: collections.Counter,
                   got: collections.Counter = None) -> dict:
    """``got`` (the launches since ``reset_launches`` when None) against
    ``want``, by kernel and K2's and K9's by length; returns them by
    kernel."""
    got = launches_now() if got is None else +got
    want = +collections.Counter(want)

    def show(c):
        return ({k: v for k, v in c.items() if isinstance(k, str)},
                {f"{k[0]}@{k[1]}": v for k, v in c.items()
                 if isinstance(k, tuple)})

    (got_k, got_n), (want_k, want_n) = show(got), show(want)
    print(f"{label}: kernel launches {got_k}, K2/K9 by N {got_n} (want "
          f"{want_k}, {want_n}, nothing else)")
    if got != want:
        fail(f"{label}: kernel launches {got_k} {got_n}, want {want_k} "
             f"{want_n}")
    return {name: got[name] for name in KERNELS}


# --------------------------------------------------------------------------
# Phase 4: the retrieval eval
# --------------------------------------------------------------------------

def seeded_params(spec, dev, seed: int = SEED):
    """f32 params from the seed; the reference starts the rel-pos table and
    the q/v biases at zero: non-zero values exercise the kernels' bias
    paths (the rel-pos bias in K2/K9, the q/v bias in K1)."""
    gen = torch.Generator().manual_seed(seed)
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


def synthetic_eval_set(spec, dev, gen, n_images: int = N_IMAGES):
    images = torch.randn(n_images, 3, spec.image_size, spec.image_size,
                         device=dev, generator=gen)
    n_txt = n_images * CAPTIONS_PER_IMAGE
    ids, masks = synthetic_captions(spec, n_txt, dev, gen)
    image_batches = [{"image": images[i:i + IMAGE_BATCH]}
                     for i in range(0, n_images, IMAGE_BATCH)]
    text_batches = [{"text_ids": ids[i:i + TEXT_BATCH],
                     "text_masks": masks[i:i + TEXT_BATCH]}
                    for i in range(0, n_txt, TEXT_BATCH)]
    tiids = np.repeat(np.arange(n_images), CAPTIONS_PER_IMAGE)
    return text_batches, image_batches, tiids, np.arange(n_images)


def images_per_sec(params, spec, image_batches, kernels: bool,
                   fusion: str = "tail", qk_int8: bool = False) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    extract_features(params, spec, image_batches, "image", kernels=kernels,
                     fusion=fusion, qk_int8=qk_int8)
    torch.cuda.synchronize()
    return sum(b["image"].shape[0] for b in image_batches) / (
        time.perf_counter() - t0)


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
    want = want_launches(ln_linear=per_image, packed_attention=per_image,
                         proj_mlp_tail=per_image,
                         mlp=spec.num_layers * len(text_batches))
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
    route_launches = run_routes(params, spec, text_batches, image_batches,
                                tiids, iids, img_p, card)
    return {k: launches[k] + route_launches[k] for k in launches}


# the kernels of each route's image block, 1 launch per layer and batch
ROUTE_KERNELS = {
    "pair": ("ln_linear", "packed_attention", "linear_residual", "mlp_tail"),
    "tail": ("ln_linear", "packed_attention", "proj_mlp_tail"),
    "qkv": ("ln_qkv_attention", "proj_mlp_tail"),
    "mega": ("block_eval",)}


def run_routes(params, spec, text_batches, image_batches, tiids, iids,
               img_plain, card: str) -> dict:
    """The image tower under each ``fusion``: launches, features against
    the plain path's and each other's, images/s in turns; then
    ``compute_irtr_recall`` under "mega"."""
    per_image = spec.num_layers * len(image_batches)
    launches = dict.fromkeys(KERNELS, 0)
    feats = {}
    for fusion in fb_ops.FUSIONS:
        reset_launches()
        with torch.no_grad():
            feats[fusion] = extract_features(params, spec, image_batches,
                                             "image", fusion=fusion)
        got = read_launches()
        want = want_launches(**dict.fromkeys(ROUTE_KERNELS[fusion],
                                             per_image))
        print(f"fusion {fusion!r}: kernel launches "
              f"{ {k: v for k, v in got.items() if v} } (want "
              f"{' '.join(ROUTE_KERNELS[fusion])} {spec.num_layers} per image "
              f"batch, nothing else)")
        if got != want:
            fail(f"fusion {fusion!r}: kernel launches {got}, want {want}")
        for k, v in got.items():
            launches[k] += v
        t = feats[fusion]
        if t.shape != (N_IMAGES, spec.hidden_size) or \
                not bool(torch.isfinite(t).all()):
            fail(f"fusion {fusion!r}: features of shape {tuple(t.shape)} or "
                 f"not finite")
        cos = min_cosine(t, img_plain)
        print(f"fusion {fusion!r}: image cls_feats vs plain path: min cosine "
              f"{cos:.6f} (need >= {MIN_COSINE})")
        if cos < MIN_COSINE:
            fail(f"fusion {fusion!r}: image features disagree with the plain "
                 f"path")
    between = min(min_cosine(feats[a], feats[b]) for a in fb_ops.FUSIONS
                  for b in fb_ops.FUSIONS if a < b)
    print(f"image cls_feats between routes: min cosine {between:.6f}; "
          f"bit-equal to 'tail': "
          + ", ".join(f"{f} {torch.equal(feats[f], feats['tail'])}"
                      for f in fb_ops.FUSIONS))

    rates = {f: [] for f in fb_ops.FUSIONS}
    for fusion in fb_ops.FUSIONS + fb_ops.FUSIONS[::-1]:
        rates[fusion].append(images_per_sec(params, spec, image_batches,
                                            kernels=True, fusion=fusion))
    best = {f: max(v) for f, v in rates.items()}
    print(f"image tower by route (ViT-B/16 @384, bf16, batch {IMAGE_BATCH}): "
          + ", ".join(f"{f} {v:.1f} img/s" for f, v in best.items())
          + f" (best of 2, {N_IMAGES} images each, in turns); fastest: "
          f"{max(best, key=best.get)} [{card}]")

    reset_launches()
    recall = compute_irtr_recall(params, spec, text_batches, image_batches,
                                 tiids, iids, fusion="mega")
    got = read_launches()
    want = want_launches(block_eval=per_image,
                         mlp=spec.num_layers * len(text_batches))
    print(f"compute_irtr_recall (fusion 'mega'): kernel launches "
          f"{ {k: v for k, v in got.items() if v} }; recall "
          + json.dumps(recall))
    if got != want:
        fail(f"eval kernel launches under 'mega' {got}, want {want}")
    if not all(0.0 <= v <= 1.0 for v in recall.values()):
        fail(f"recall out of range: {recall}")
    for k, v in got.items():
        launches[k] += v
    return launches


# --------------------------------------------------------------------------
# Phase 5: the W8A8 int8 eval
# --------------------------------------------------------------------------

class int8_plain_path:
    """Within the block, mome's int8 eval blocks run the plain twins
    (``ref_fused_eval_block_i8``) instead of K14 → K2/K12 → K15."""

    def __enter__(self):
        mome.fused_eval_block_i8 = i8_ops.ref_fused_eval_block_i8

    def __exit__(self, *exc):
        mome.fused_eval_block_i8 = i8_ops.fused_eval_block_i8


def min_cosine(a, b) -> float:
    return float(F.cosine_similarity(a.float(), b.float(), dim=-1).min())


def run_eval_int8(dev, card: str) -> dict:
    cfg = build_config(*CONFIG, overrides=dict(eval_int8=True))
    spec = make_model_spec(cfg)
    base = seeded_params(spec, dev)
    params = eval_cast_params(base, spec, cfg)
    params_bf16 = {k: v for k, v in params.items() if "::" not in k}
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    text_batches, image_batches, tiids, iids = synthetic_eval_set(
        spec, dev, gen)
    L = spec.num_layers
    per_image = L * len(image_batches)

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recall = compute_irtr_recall(params, spec, text_batches, image_batches,
                                 tiids, iids)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    want = want_launches(ln_linear_i8=per_image, packed_attention=per_image,
                         proj_mlp_tail_i8=per_image,
                         mlp=L * len(text_batches))
    print(f"int8 compute_irtr_recall: {seconds:.3f} s for {N_IMAGES} images "
          f"and {len(tiids)} captions; kernel launches {launches} (want "
          f"K14, K2, K15 {L} per image batch, K13 {L} per text batch)")
    if launches != want:
        fail(f"int8 eval kernel launches {launches}, want {want}")
    print("int8 recall: " + json.dumps(recall))
    if not all(0.0 <= v <= 1.0 for v in recall.values()):
        fail(f"int8 recall out of range: {recall}")

    reset_launches()
    with torch.no_grad():
        img_qk = extract_features(params, spec, image_batches, "image",
                                  qk_int8=True)
    qk_launches = read_launches()
    want = want_launches(ln_linear_i8=per_image,
                         packed_attention_i8qk=per_image,
                         proj_mlp_tail_i8=per_image)
    print(f"int8 image tower with qk_int8: kernel launches {qk_launches} "
          f"(want K14, K12, K15 {L} per image batch, K2 0)")
    if qk_launches != want:
        fail(f"int8-QK kernel launches {qk_launches}, want {want}")

    with torch.no_grad():
        img_k = extract_features(params, spec, image_batches, "image")
        img_bf16 = extract_features(params_bf16, spec, image_batches,
                                    "image")
        with int8_plain_path():
            img_p = extract_features(params, spec, image_batches, "image")
            img_qk_p = extract_features(params, spec, image_batches,
                                        "image", qk_int8=True)
    for name, t in (("int8", img_k), ("int8-QK", img_qk), ("plain", img_p),
                    ("plain int8-QK", img_qk_p)):
        if t.shape != (N_IMAGES, spec.hidden_size) or \
                not bool(torch.isfinite(t).all()):
            fail(f"{name} image features: shape {tuple(t.shape)} or not "
                 f"finite")
    for name, k, p in (("int8", img_k, img_p),
                       ("int8-QK", img_qk, img_qk_p)):
        cos = min_cosine(k, p)
        print(f"{name} image cls_feats, kernels vs int8 plain path: min "
              f"cosine {cos:.6f} (need >= {MIN_COSINE})")
        if cos < MIN_COSINE:
            fail(f"{name} kernel-path image features disagree with the "
                 f"int8 plain path")
    print(f"int8 image cls_feats against the bf16 kernel path (no gate): "
          f"min cosine {min_cosine(img_k, img_bf16):.6f}; int8-QK "
          f"{min_cosine(img_qk, img_bf16):.6f}")

    # int8 kernels, int8-QK kernels (K12 for K2), int8 plain, the bf16
    # kernels by "tail" and by "mega", and back: compare only here
    paths = {"int8 kernels": (params, False, "tail", False),
             "int8-QK kernels": (params, False, "tail", True),
             "int8 plain": (params, True, "tail", False),
             "bf16 kernels 'tail'": (params_bf16, False, "tail", False),
             "bf16 kernels 'mega'": (params_bf16, False, "mega", False)}
    rates = {k: [] for k in paths}
    order = list(paths) + list(paths)[::-1]
    for which in order:
        p, plain, fusion, qk_int8 = paths[which]
        with int8_plain_path() if plain else contextlib.nullcontext():
            rates[which].append(images_per_sec(p, spec, image_batches,
                                               kernels=True, fusion=fusion,
                                               qk_int8=qk_int8))
    print(f"image tower (ViT-B/16 @384, batch {IMAGE_BATCH}): "
          + ", ".join(f"{k} {max(v):.1f} img/s" for k, v in rates.items())
          + f" (best of 2, {N_IMAGES} images each) [{card}]")
    return {k: launches[k] + qk_launches[k] for k in launches}


# --------------------------------------------------------------------------
# Phase 6: the irtr fine-tune step
# --------------------------------------------------------------------------

def train_config(kernels: bool):
    return build_config(*CONFIG, overrides=dict(
        per_device_batch_size=MICRO_BATCH, batch_size=2 * MICRO_BATCH,
        warmup_steps=0, pallas_attention=kernels))


def synthetic_train_batch(spec, accum: int, dev, gen,
                          micro: int = MICRO_BATCH):
    """(accum, micro, ...) image/caption pairs."""
    n = accum * micro
    images = torch.randn(n, 3, spec.image_size, spec.image_size, device=dev,
                         generator=gen)
    ids, masks = synthetic_captions(spec, n, dev, gen)
    return {k: v.reshape(accum, micro, *v.shape[1:]) for k, v in
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


def global_norm_ratio(a: dict, b: dict) -> float:
    """The global norm of ``a`` over that of ``b``: what the cosine cannot
    see, a scale."""
    na = sum(a[k].double().square().sum() for k in a)
    nb = sum(b[k].double().square().sum() for k in b)
    return float(torch.sqrt(na / nb))


def run_training(dev, card: str) -> dict:
    """The irtr fine-tune step: the kernel path's losses and gradients
    against the plain path's on one micro-batch; a warm-up step and
    TIMED_STEPS steps of each path in turns, K2, K9 and K13 launched as
    the routing gives them (the image tower's 577 tokens take K2/K9, both
    towers' MLPs K13)."""
    cfg = train_config(kernels=True)
    spec = make_model_spec(cfg)
    accum = accum_steps(cfg)
    base = seeded_params(spec, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    batch = synthetic_train_batch(spec, accum, dev, gen)
    label = f"irtr fine-tune @384 ({accum} x {MICRO_BATCH} pairs)"
    against_plain(label, cfg, spec, base, {k: v[0] for k, v in batch.items()},
                  dev)
    runs = {which: build_train_step(train_config(which == "kernels"), spec,
                                    master_params(base), TRAIN_STEPS)
            for which in ("kernels", "plain")}
    L = spec.num_layers
    want = scaled(block_launches(N, MICRO_BATCH, L)
                  + block_launches(spec.max_text_len, MICRO_BATCH, L), accum)
    return train_in_turns(label, runs, batch, accum * MICRO_BATCH,
                          {"kernels": want}, card)


# --------------------------------------------------------------------------
# Phase 7: the Flickr30k @224 retrieval eval (the split attention kernels)
# --------------------------------------------------------------------------

def run_eval_224(dev, card: str) -> dict:
    cfg = build_config(*CONFIG_224)
    spec = make_model_spec(cfg)
    if spec.image_len != N_224:
        fail(f"@224 image tokens {spec.image_len}, expected {N_224}")
    params = eval_cast_params(seeded_params(spec, dev), spec, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    text_batches, image_batches, tiids, iids = synthetic_eval_set(
        spec, dev, gen, N_IMAGES_224)
    L = spec.num_layers
    full = sum(b["image"].shape[0] % attn_ops.SPLIT_BB == 0
               for b in image_batches)
    ragged = len(image_batches) - full

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recall = compute_irtr_recall(params, spec, text_batches, image_batches,
                                 tiids, iids)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    want = want_launches(split_attention_bb=L * full,
                         split_attention=L * ragged,
                         mlp=L * (len(image_batches) + len(text_batches)))
    print(f"@224 compute_irtr_recall: {seconds:.3f} s for {len(iids)} images "
          f"(batches {[b['image'].shape[0] for b in image_batches]}) and "
          f"{len(tiids)} captions; kernel launches "
          f"{ {k: v for k, v in launches.items() if v} } (want K11 {L} per "
          f"image batch of 32, K10 {L} for the batch of {K10_BATCH}, K13 "
          f"{L} per image and per text batch, nothing else)")
    if launches != want:
        fail(f"@224 eval kernel launches {launches}, want {want}")
    print("@224 recall: " + json.dumps(recall))
    if not all(0.0 <= v <= 1.0 for v in recall.values()):
        fail(f"@224 recall out of range: {recall}")

    with torch.no_grad():
        img_k = extract_features(params, spec, image_batches, "image")
        img_p = extract_features(params, spec, image_batches, "image",
                                 kernels=False)
    for t in (img_k, img_p):
        if t.shape != (len(iids), spec.hidden_size) or \
                not bool(torch.isfinite(t).all()):
            fail(f"@224 image features: shape {tuple(t.shape)} or not finite")
    cos = min_cosine(img_k, img_p)
    print(f"@224 image cls_feats, kernels vs plain path: min cosine "
          f"{cos:.6f} (need >= {MIN_COSINE})")
    if cos < MIN_COSINE:
        fail("@224 kernel-path image features disagree with the plain path")

    rates = {"plain": [], "kernels": []}
    for which in ("plain", "kernels", "kernels", "plain"):
        rates[which].append(images_per_sec(params, spec, image_batches,
                                           kernels=which == "kernels"))
    print(f"image tower (ViT-B/16 @224, bf16, batches of {IMAGE_BATCH} and "
          f"{K10_BATCH}): kernels {max(rates['kernels']):.1f} img/s, plain "
          f"{max(rates['plain']):.1f} img/s (best of 2, {len(iids)} images "
          f"each) [{card}]")
    return launches


# --------------------------------------------------------------------------
# Phase 8: the irtr fine-tune step under the training fusion
# --------------------------------------------------------------------------

def run_train_fusion(dev, card: str) -> dict:
    """The irtr fine-tune step under each ``train_fusion``: "tail"'s and
    "full"'s gradients against "0"'s on one micro-batch; a warm-up step
    and TIMED_STEPS steps of each level in turns, K6 (and K1 under
    "full") in place of K13."""
    cfg = train_config(kernels=True)
    spec = make_model_spec(cfg)
    accum = accum_steps(cfg)
    L = spec.num_layers
    base = seeded_params(spec, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    batch = synthetic_train_batch(spec, accum, dev, gen)
    levels = ("0", "tail", "full")

    # each level's gradients against level "0": same params, micro-batch
    # and random draws
    params = master_params(base)
    mb = {k: v[0] for k, v in batch.items()}
    grads = {}
    for level in levels:
        g = torch.Generator(device=dev).manual_seed(SEED + 6)
        loss, _, grads[level] = train_step.loss_and_grads(
            params, spec, cfg, mb, g, kernels=True, train_fusion=level)
        print(f"micro-batch loss, train_fusion {level!r}: {float(loss):.6f}")
    for level in levels[1:]:
        cos = global_cosine(grads[level], grads["0"])
        print(f"gradients, train_fusion {level!r} vs '0': global cosine "
              f"{cos:.6f} (need >= {MIN_COSINE})")
        if cos < MIN_COSINE:
            fail(f"train_fusion {level!r}: gradients disagree with level "
                 f"'0'")
    del grads, params

    runs = {level: build_train_step(cfg, spec, master_params(base),
                                    TRAIN_STEPS, train_fusion=level)
            for level in levels}
    want = {level: scaled(block_launches(N, MICRO_BATCH, L, level)
                          + block_launches(spec.max_text_len, MICRO_BATCH, L,
                                           level), accum)
            for level in levels}
    return train_in_turns(f"irtr fine-tune @384 ({accum} x {MICRO_BATCH} "
                          f"pairs), train_fusion", runs, batch,
                          accum * MICRO_BATCH, want, card)


# --------------------------------------------------------------------------
# Phase 9: ViT-L @384 (C=1024), the width the kernels are built for beside
# ViT-B's
# --------------------------------------------------------------------------

def run_large(dev, card: str) -> dict:
    """The ViT-L towers (the image tower by "tail", "qkv" and "mega" and in
    the W8A8 int8 eval) and fine-tune step: launches per block, features
    and gradients against the plain path."""
    cfg = build_config(*CONFIG_L)
    spec = make_model_spec(cfg)
    if (spec.hidden_size, spec.num_heads, spec.image_len) != \
            (C_L, HEADS_L, N):
        fail(f"ViT-L spec {spec.hidden_size}/{spec.num_heads}/"
             f"{spec.image_len}, expected {C_L}/{HEADS_L}/{N}")
    L = spec.num_layers
    base = seeded_params(spec, dev)
    params = eval_cast_params(base, spec, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    images = [{"image": torch.randn(L_IMAGES, 3, spec.image_size,
                                    spec.image_size, device=dev,
                                    generator=gen)}]
    ids, masks = synthetic_captions(spec, L_CAPTIONS, dev, gen)
    texts = [{"text_ids": ids, "text_masks": masks}]
    launches = dict.fromkeys(KERNELS, 0)
    feats, plain_feats = {}, {}
    for tower, batches, want in (
            ("image", images, want_launches(ln_linear=L, packed_attention=L,
                                            proj_mlp_tail=L)),
            ("text", texts, want_launches(mlp=L))):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            got = extract_features(params, spec, batches, tower)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_launches()
        print(f"ViT-L {tower} tower ({len(got)} "
              f"{'images' if tower == 'image' else 'captions'}, {L} layers, "
              f"C={C_L}): {seconds:.3f} s; kernel launches "
              f"{ {k: v for k, v in counts.items() if v} } (want "
              f"{ {k: v for k, v in want.items() if v} })")
        if counts != want:
            fail(f"ViT-L {tower} tower launches {counts}, want {want}")
        for k, v in counts.items():
            launches[k] += v
        with torch.no_grad():
            plain = extract_features(params, spec, batches, tower,
                                     kernels=False)
        if got.shape != plain.shape or got.shape[1] != C_L or \
                not bool(torch.isfinite(got).all()):
            fail(f"ViT-L {tower} features: shape {tuple(got.shape)} or not "
                 f"finite")
        cos = min_cosine(got, plain)
        print(f"ViT-L {tower} cls_feats, kernels vs plain path: min cosine "
              f"{cos:.6f} (need >= {MIN_COSINE})")
        if cos < MIN_COSINE:
            fail(f"ViT-L {tower} features disagree with the plain path")
        feats[tower], plain_feats[tower] = got, plain
    # the image tower by "qkv": K8 (built for C=1024) and K3
    reset_launches()
    with torch.no_grad():
        got = extract_features(params, spec, images, "image", fusion="qkv")
    counts = read_launches()
    want = want_launches(ln_qkv_attention=L, proj_mlp_tail=L)
    same = torch.equal(got, feats["image"])
    print(f"ViT-L image tower by fusion 'qkv': kernel launches "
          f"{ {k: v for k, v in counts.items() if v} } (want "
          f"{ {k: v for k, v in want.items() if v} }); cls_feats bit-equal to "
          f"the default route's {same}")
    if counts != want:
        fail(f"ViT-L 'qkv' image tower launches {counts}, want {want}")
    if not same:
        fail("ViT-L 'qkv' image features differ from the default route's")
    for k, v in counts.items():
        launches[k] += v
    # the image tower by "mega": K7 (built for C=1024), bit-equal to the
    # default route's K1 -> K2 -> K3
    reset_launches()
    with torch.no_grad():
        got = extract_features(params, spec, images, "image", fusion="mega")
    counts = read_launches()
    want = want_launches(block_eval=L)
    same = torch.equal(got, feats["image"])
    cos = min_cosine(got, plain_feats["image"])
    print(f"ViT-L image tower by fusion 'mega': kernel launches "
          f"{ {k: v for k, v in counts.items() if v} } (want "
          f"{ {k: v for k, v in want.items() if v} }); cls_feats bit-equal to "
          f"the default route's {same}, min cosine to the plain path "
          f"{cos:.6f} (need >= {MIN_COSINE})")
    if counts != want:
        fail(f"ViT-L 'mega' image tower launches {counts}, want {want}")
    if not same or cos < MIN_COSINE:
        fail("ViT-L 'mega' image features differ from the default route's "
             "or disagree with the plain path")
    for k, v in counts.items():
        launches[k] += v
    # the W8A8 int8 eval's image tower: K14 -> K2 -> K15 (built for C=1024)
    cfg8 = build_config(*CONFIG_L, overrides=dict(eval_int8=True))
    spec8 = make_model_spec(cfg8)
    params8 = eval_cast_params(base, spec8, cfg8)
    reset_launches()
    with torch.no_grad():
        got8 = extract_features(params8, spec8, images, "image")
    counts = read_launches()
    want = want_launches(ln_linear_i8=L, packed_attention=L,
                         proj_mlp_tail_i8=L)
    with torch.no_grad(), int8_plain_path():
        plain8 = extract_features(params8, spec8, images, "image")
    finite = got8.shape == plain8.shape and bool(torch.isfinite(got8).all())
    cos = min_cosine(got8, plain8)
    print(f"ViT-L int8 image tower (W8A8): kernel launches "
          f"{ {k: v for k, v in counts.items() if v} } (want "
          f"{ {k: v for k, v in want.items() if v} }); cls_feats finite "
          f"{finite}, min cosine to the int8 plain path {cos:.6f} (need >= "
          f"{MIN_COSINE}); to the bf16 kernel path (no gate) "
          f"{min_cosine(got8, feats['image']):.6f}")
    if counts != want:
        fail(f"ViT-L int8 image tower launches {counts}, want {want}")
    if not finite or cos < MIN_COSINE:
        fail("ViT-L int8 kernel-path image features disagree with the int8 "
             "plain path")
    for k, v in counts.items():
        launches[k] += v
    # the image tower's rates by path, in turns: plain, the kernels by
    # "tail" and by "mega", the int8 kernels, and back
    paths = {"plain": (params, spec, False, "tail"),
             "kernels 'tail'": (params, spec, True, "tail"),
             "kernels 'mega'": (params, spec, True, "mega"),
             "int8 kernels": (params8, spec8, True, "tail")}
    rates = {k: [] for k in paths}
    for which in list(paths) + list(paths)[::-1]:
        p, sp, kernels, fusion = paths[which]
        rates[which].append(images_per_sec(p, sp, images, kernels=kernels,
                                           fusion=fusion))
    print(f"image tower (ViT-L/16 @384, batch {L_IMAGES}): "
          + ", ".join(f"{k} {max(v):.1f} img/s" for k, v in rates.items())
          + f" (best of 2, in turns) [{card}]")
    del params, params8

    # the fine-tune step at micro-batch L_MICRO, one micro-batch a step
    tcfg = build_config(*CONFIG_L, overrides=dict(
        per_device_batch_size=L_MICRO, batch_size=L_MICRO, warmup_steps=0,
        pallas_attention=True))
    accum = accum_steps(tcfg)
    batch = synthetic_train_batch(spec, accum, dev, gen, micro=L_MICRO)
    mb = {k: v[0] for k, v in batch.items()}
    step_batch = batch if accum > 1 else mb   # one micro-batch: no accum axis
    for level in ("0", "full"):
        state, step = build_train_step(tcfg, spec, master_params(base),
                                       L_STEPS, train_fusion=level)
        reset_launches()
        ms = []
        for i in range(L_STEPS):
            state, metrics, t = timed_step(step, state, step_batch)
            ms.append(t)
            loss, gnorm = float(metrics["total_loss"]), \
                float(metrics["grad_norm"])
            if not (np.isfinite(loss) and np.isfinite(gnorm)):
                fail(f"ViT-L train step (train_fusion {level!r}): loss or "
                     f"grad norm not finite")
        counts = read_launches()
        micro = L_STEPS * accum
        want = want_launches(packed_attention=L * micro,
                             packed_attention_bwd=L * micro,
                             mlp=2 * L * micro) if level == "0" else \
            want_launches(packed_attention=L * micro,
                          packed_attention_bwd=L * micro,
                          tail_train=2 * L * micro, ln_linear=2 * L * micro)
        print(f"ViT-L train step (train_fusion {level!r}, micro-batch "
              f"{L_MICRO}, {L} layers): loss {loss:.6f}, grad norm "
              f"{gnorm:.6f}, {min(ms):.1f} ms (best of {L_STEPS}, the first "
              f"warms up); kernel launches "
              f"{ {k: v for k, v in counts.items() if v} } (want "
              f"{ {k: v for k, v in want.items() if v} }) [{card}]")
        if counts != want:
            fail(f"ViT-L train launches {counts}, want {want}")
        for k, v in counts.items():
            launches[k] += v
        del state, step

    params = master_params(base)
    grads = {}
    for kernels in (True, False):
        g = torch.Generator(device=dev).manual_seed(SEED + 8)
        loss, _, grads[kernels] = train_step.loss_and_grads(
            params, spec, tcfg, mb, g, kernels=kernels)
        if not bool(torch.isfinite(loss)):
            fail("ViT-L micro-batch loss not finite")
        print(f"ViT-L micro-batch loss, {'kernel' if kernels else 'plain'} "
              f"path: {float(loss):.6f}")
    cos = global_cosine(grads[True], grads[False])
    finite = all(bool(torch.isfinite(t).all()) for t in grads[True].values())
    print(f"ViT-L gradients, kernel vs plain path: global cosine {cos:.6f} "
          f"(need >= {MIN_COSINE}), all finite {finite}")
    if cos < MIN_COSINE or not finite:
        fail("ViT-L kernel-path gradients disagree with the plain path")
    return launches


# --------------------------------------------------------------------------
# Phase 10: the vit-tiny width (C=192), which no K1/K3/K13/K6 is built for
# --------------------------------------------------------------------------

def run_tiny(dev, card: str) -> dict:
    """The vit-tiny spec's towers in the eval and an irtr step at its width
    on the card: the routing takes the plain ops for K1/K3/K13/K6 (their
    twins' work runs as PyTorch ops, no kernel of theirs launches), and
    the attention keeps its kernels."""
    cfg = build_config(*CONFIG_TINY)
    spec = make_model_spec(cfg)
    if spec.hidden_size != 192:
        fail(f"vit-tiny width {spec.hidden_size}, expected 192")
    params = eval_cast_params(seeded_params(spec, dev), spec, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    images = [{"image": torch.randn(IMAGE_BATCH, 3, spec.image_size,
                                    spec.image_size, device=dev,
                                    generator=gen)}]
    ids, masks = synthetic_captions(spec, 4 * TEXT_BATCH, dev, gen)
    reset_launches()
    with torch.no_grad():
        for tower, batches in (("image", images), ("text", [
                {"text_ids": ids, "text_masks": masks}])):
            f = extract_features(params, spec, batches, tower)
            if not bool(torch.isfinite(f).all()):
                fail(f"vit-tiny {tower} features not finite")
    eval_counts = read_launches()
    # an irtr step at the vit-tiny width (the config's own tasks are
    # pretraining), under the training fusion that would take K1 and K6
    tcfg = build_config(CONFIG[0], CONFIG[1], overrides=dict(
        hidden_size=192, num_heads=3, vit="vit_tiny_patch16_224",
        image_size=224, per_device_batch_size=MICRO_BATCH,
        batch_size=MICRO_BATCH, warmup_steps=0, pallas_attention=True))
    tspec = make_model_spec(tcfg)
    batch = {k: v[0] for k, v in synthetic_train_batch(
        tspec, 1, dev, gen).items()}
    reset_launches()
    for level in ("0", "full"):
        state, step = build_train_step(tcfg, tspec,
                                       master_params(seeded_params(tspec,
                                                                   dev)),
                                       2, train_fusion=level)
        state, metrics = step(state, batch)
        if not bool(torch.isfinite(metrics["total_loss"])):
            fail(f"vit-tiny train step ({level!r}): loss not finite")
    train_counts = read_launches()
    print(f"vit-tiny (C=192): eval launches "
          f"{ {k: v for k, v in eval_counts.items() if v} }, irtr steps "
          f"(train_fusion '0' and 'full') launches "
          f"{ {k: v for k, v in train_counts.items() if v} } (want no "
          f"{', '.join(TINY_KERNELS)})")
    for counts in (eval_counts, train_counts):
        if any(counts[k] for k in TINY_KERNELS):
            fail(f"vit-tiny launched a kernel not built for C=192: {counts}")
    return {k: eval_counts[k] + train_counts[k] for k in KERNELS}


# --------------------------------------------------------------------------
# Phase 11: the merging suite
# --------------------------------------------------------------------------

# the all_moe checkpoint the merging suite starts from: the COCO @384
# config at full width and depth, with its v, l (and, in layers 10-11, vl)
# experts (381 tensors, 210.5 M parameters)
CONFIG_MOE = (CONFIG[0], "all_moe")
# the gram pass: f32_device over 64 image/caption pairs in batches of 32;
# f64_host (about 1.2 TFLOP of f64 xᵀx on the host per 8 pairs at this
# width) and f32_device again over the first 8 pairs alone
GRAM_PAIRS, GRAM_BATCH, GRAM_F64_PAIRS = 64, 32, 8
MERGE_RATIO, SUM_LAMBDA, NON_DIAG = 0.5, 0.5, 0.9
# device merging: a fleet of 8 all_moe checkpoints (~6.3 GiB f32 on the
# card) and a sweep of 11 ratios over one
FLEET, SWEEP = 8, 11
F32_EPS, F64_EPS = 2.0 ** -24, 2.0 ** -53


def regmean_bound(dim: int, kappa: float) -> float:
    """The least relative drift regmean_device (f32 products Σ w·G, an f32
    LU solve) may show from the host f64 regmean, max |Δ| over max |w|:
    each f32 stage rounds with an error that grows as √D·u over its
    D-term sums (u = 2^-24), and the solve amplifies the error by at most
    the condition number κ of the summed grams; 2 for the two stages.
    (A CPU model of these grams, f32 against f64, drifted by 0.24 of
    √D·κ·u at κ 4.3, D 768, and by 0.003 of it at κ 1945, D 3072.)"""
    return 2.0 * dim ** 0.5 * kappa * F32_EPS


# the second, tighter regmean_device limit, as a share of regmean_bound:
# the worst-case bound alone lets a ~9% drift through at proj (κ ≈ 2.6e4,
# D = 768), where an H100 measured at most 0.0165 of it for any weight;
# 0.1 keeps six times that reading as room
REGMEAN_MEASURED_SHARE = 0.1


def seeded_state(spec, seed: int) -> dict:
    """A seeded checkpoint of ``spec``'s schema as a host numpy dict."""
    return params_to_state_dict(seeded_params(spec, "cpu", seed))


def seeded_expert_state(spec, seed: int) -> dict:
    """``seeded_state`` with every LayerNorm's weight and bias drawn too
    (1 + 0.1·N(0, 1), 0.1·N(0, 1); the init sets 1 and 0): the experts'
    norms then differ, and a merge of a mode whose only experts are its
    norms (ln_moe) is no copy of its checkpoint."""
    sd = seeded_state(spec, seed)
    rng = np.random.default_rng(seed)
    for k, v in sd.items():
        if ".norm" in k:
            sd[k] = (float(k.endswith(".weight")) + 0.1 * rng.standard_normal(
                v.shape)).astype(v.dtype)
    return sd


def bit_equal(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


# the irtr gram pass's tapped modules by mode: each expert's v (image) and
# l (text) inputs ("{}"), the shared modules by ufo's names (the reference's
# lists: MOE_GRAM_SUFFIXES under use_moe, else UFO_GRAM_SUFFIXES, whose
# norms ln_moe's per-modality LayerNorms do not match)
GRAM_MODULES = {"all_moe": ("attn.{}", "attn.{}.proj", "mlp.{}.fc1",
                            "mlp.{}.fc2"),
                "ln_moe": ("attn.proj", "mlp.fc1", "mlp.fc2"),
                "attn_moe": ("attn.{}", "attn.{}.proj", "mlp.fc1",
                             "mlp.fc2"),
                "ffn_moe": ("attn", "attn.proj", "mlp.{}.fc1", "mlp.{}.fc2")}


def gram_keys(spec, mode: str = "all_moe") -> set:
    """The irtr gram pass's tapped modules in ``mode`` (``GRAM_MODULES``)."""
    keys = {f"transformer.blocks.{i}.{m.format(e)}"
            for i in range(spec.num_layers) for m in GRAM_MODULES[mode]
            for e in ("vl" if "{}" in m else "-")}
    if not all(k.endswith(MOE_GRAM_SUFFIXES + UFO_GRAM_SUFFIXES)
               for k in keys):
        fail("gram keys outside the reference's lists")
    return keys


def gram_rows(spec, key: str, pairs: int) -> int:
    """Rows summed into a gram over ``pairs`` pairs: image tokens for a v
    expert, text tokens for an l expert, both for a shared module."""
    expert = (key.split(".") + [""])[4]
    return pairs * {"v": spec.image_len, "l": spec.max_text_len}.get(
        expert, spec.image_len + spec.max_text_len)


def run_gram_pass(params, spec, cfg, batches, precision: str, label: str,
                  mode: str = "all_moe"):
    """One ``cache_gram_matrices`` call with its launches gated: K2 once
    per layer and image batch, nothing else (the taps turn off the fused
    eval block and K13); its keys ``gram_keys(spec, mode)``."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grams = cache_gram_matrices(params, spec, cfg, batches,
                                precision=precision)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    want = want_launches(packed_attention=spec.num_layers * len(batches))
    if launches != want:
        fail(f"gram pass {label}: launches {launches}, want {want}")
    if set(grams) != gram_keys(spec, mode):
        fail(f"gram pass {label}: keys "
             f"{sorted(set(grams) ^ gram_keys(spec, mode))} differ from the "
             f"irtr set of {mode}")
    eps = F64_EPS if precision == "f64_host" else F32_EPS
    pairs = sum(b["image"].shape[0] for b in batches)
    for k, g in grams.items():
        # g_ij and g_ji each within γ_rows = rows·eps of the exact sum
        # (any summation order), so |g - gᵀ| within 2·rows·eps·max|g|
        sym = float(np.abs(g - g.T).max())
        if g.dtype != np.float64 or not np.isfinite(g).all() or \
                sym > 2 * gram_rows(spec, k, pairs) * eps * np.abs(g).max():
            fail(f"gram {k} ({label}): dtype {g.dtype}, finite "
                 f"{np.isfinite(g).all()}, asymmetry {sym}")
    return grams, seconds, launches


def check_merged_eval(params, spec, cfg, dev, label: str, eval_set):
    """``compute_irtr_recall`` on a checkpoint's params (a merged one, or a
    partial mode's own): K1-K3 12 per image batch, K13 12 per text batch;
    image and text features finite and within cosine 0.999 of the plain
    path's on the same params; the ITC scores within MAX_SCORE_DELTA of
    the plain path's.  A top-k hit turns on the sign of a difference of
    two scores, which moves by at most 2δ when no score moves by more than
    δ: so the recall may differ from the plain path's (printed beside)
    only by hits whose plain margin is within 2·MAX_SCORE_DELTA."""
    text_batches, image_batches, tiids, iids = eval_set
    params = eval_cast_params(params_from_numpy(params, dev), spec, cfg)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recall = compute_irtr_recall(params, spec, text_batches, image_batches,
                                 tiids, iids)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    per_image = spec.num_layers * len(image_batches)
    want = want_launches(ln_linear=per_image, packed_attention=per_image,
                         proj_mlp_tail=per_image,
                         mlp=spec.num_layers * len(text_batches))
    if launches != want:
        fail(f"{label} eval launches {launches}, want {want}")
    cosines, feats = {}, {}
    with torch.no_grad():
        for kind, batches, n in (("image", image_batches, len(iids)),
                                 ("text", text_batches, len(tiids))):
            k = extract_features(params, spec, batches, kind)[:n]
            p = extract_features(params, spec, batches, kind,
                                 kernels=False)[:n]
            if not (bool(torch.isfinite(k).all())
                    and bool(torch.isfinite(p).all())):
                fail(f"{label} {kind} features not finite")
            cosines[kind] = float(F.cosine_similarity(
                k.float(), p.float(), dim=-1).min())
            feats[kind] = (k, p)
    (img_k, img_p), (txt_k, txt_p) = feats["image"], feats["text"]
    delta = float((img_k.float() @ txt_k.float().T
                   - img_p.float() @ txt_p.float().T).abs().max())
    plain = retrieval_recall(img_p, txt_p, iids, tiids)
    print(f"{label}: compute_irtr_recall {seconds:.3f} s for {len(iids)} "
          f"images and {len(tiids)} captions, launches as wanted; min "
          f"cosine to the plain path image {cosines['image']:.6f}, text "
          f"{cosines['text']:.6f} (need >= {MIN_COSINE}); max |Δ ITC score| "
          f"{delta:.4e} (need <= {MAX_SCORE_DELTA}); recall "
          f"{json.dumps(recall)}, the plain path's {json.dumps(plain)}, "
          f"equal {recall == plain}")
    if min(cosines.values()) < MIN_COSINE:
        fail(f"{label}: kernel-path features disagree with the plain path")
    if delta > MAX_SCORE_DELTA:
        fail(f"{label}: the ITC scores differ from the plain path's by "
             f"{delta} > {MAX_SCORE_DELTA}")
    if not all(0.0 <= v <= 1.0 for v in recall.values()):
        fail(f"{label}: recall out of range: {recall}")
    return launches


def fleet_within_4_ulp(fleet: dict, hosts: list, dev, label: str) -> None:
    """Every member of a device fleet within 4 f32 ulp at operand scale of
    the host result (the pin of the JAX package's device merging)."""
    for j, host in enumerate(hosts):
        if set(host) != set(fleet):
            fail(f"{label} member {j}: keys differ from the host path's")
        for k, h in host.items():
            want = torch.from_numpy(np.asarray(h)).to(dev).double()
            err = float((fleet[k][j].double() - want).abs().max())
            tol = 4 * float(np.spacing(np.float32(max(
                float(want.abs().max()), 1.0))))
            if err > tol:
                fail(f"{label} member {j} {k}: max |Δ| {err} > 4 ulp {tol}")


def merge_kw(spec, loss_names: dict) -> dict:
    """The merge functions' schema arguments for ``spec``."""
    return dict(num_layers=spec.num_layers,
                vlffn_start_layer_index=spec.vlffn_start_layer_index,
                loss_names=loss_names)


def run_ratio_sweep(sd_moe, spec, loss_names: dict, dev, card: str) -> None:
    """``ratio_sweep`` of SWEEP ratios over one checkpoint on the card, each
    within 4 ulp of the host path."""
    kw = merge_kw(spec, loss_names)
    grid = np.linspace(0.0, 1.0, SWEEP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    swept = merging_device.ratio_sweep(sd_moe, grid, **kw)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    fleet_within_4_ulp(swept, [merging.merge_weights(
        sd_moe, merge_ratio=float(r), **kw) for r in grid], dev,
        "ratio_sweep")
    print(f"ratio_sweep of {SWEEP} {SWEEP / sweep_s:.2f} checkpoints/s (the "
          f"copy to the card included); each within 4 ulp of the host path "
          f"[{card}]")


def run_device_merging(sd_moe, central, grams64, host_regmean, spec, dev,
                       card: str, *, loss_names: dict, size: int = FLEET,
                       label: str = "all_moe") -> None:
    """A fleet of ``size`` seeded checkpoints merged on the card by
    ``merge_weights_device`` (a ratio per member) and
    ``sum_task_vectors_device``, each member within 4 ulp of the host
    path; ``regmean_device`` on the f64
    grams cast to f32 against the host f64 regmean (``host_regmean()``,
    called when it is needed) within
    ``REGMEAN_MEASURED_SHARE`` of ``regmean_bound`` at each summed gram's
    condition number (a weight whose experts have no grams, a shared
    module, passes through: 4 ulp).  The fleet's rate is printed end to
    end (copies to and from the card included) beside the merge alone."""
    kw = merge_kw(spec, loss_names)
    members = []
    for j in range(size):
        gen = torch.Generator(device=dev).manual_seed(SEED + 30 + j)
        members.append({k: (torch.from_numpy(v).to(dev) + 0.01 * torch.randn(
            v.shape, device=dev, generator=gen)).cpu().numpy()
            for k, v in sd_moe.items()})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet = merging_device.stack_checkpoints(members)
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    ratios = np.linspace(0.2, 0.9, size).astype(np.float32)
    merge_s = []
    for _ in range(2):   # the first call warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merged = merging_device.merge_weights_device(
            fleet, merge_ratio=ratios, **kw)
        torch.cuda.synchronize()
        merge_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    merged_host = {k: v.cpu() for k, v in merged.items()}
    unstack_s = time.perf_counter() - t0
    del merged_host
    # all the work over all the time: the fleet's copy to the card, its
    # merge, the merged fleet's copy back to the host
    end_to_end_s = stack_s + merge_s[1] + unstack_s
    host_s = []
    hosts = []
    for j, sd in enumerate(members):
        t0 = time.perf_counter()
        hosts.append(merging.merge_weights(sd, merge_ratio=float(ratios[j]),
                                           **kw))
        host_s.append(time.perf_counter() - t0)
    fleet_within_4_ulp(merged, hosts, dev, "merge_weights_device")
    del merged, hosts
    cfleet = {k: v.expand(size, *v.shape[1:]) for k, v in
              merging_device.stack_checkpoints([central]).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tv = merging_device.sum_task_vectors_device(fleet, cfleet,
                                                sum_lambda=SUM_LAMBDA, **kw)
    torch.cuda.synchronize()
    tv_s = time.perf_counter() - t0
    fleet_within_4_ulp(tv, [merging.sum_task_vectors(
        sd, dict(central), sum_lambda=SUM_LAMBDA, **kw) for sd in members],
        dev, "sum_task_vectors_device")
    del tv, fleet, cfleet, members
    print(f"{label}: device merging (fleet of {size} checkpoints, "
          f"{sum(v.size for v in sd_moe.values()) / 1e6:.1f} M parameters "
          f"each, f32): merge_weights_device end to end "
          f"{size / end_to_end_s:.4f} checkpoints/s ({end_to_end_s:.3f} s: "
          f"the fleet's copy to the card {stack_s:.3f} s, the merge "
          f"{merge_s[1]:.4f} s, the copy back {unstack_s:.3f} s), the merge "
          f"alone on the resident fleet {size / merge_s[1]:.2f} "
          f"checkpoints/s (first call {merge_s[0]:.4f} s); "
          f"sum_task_vectors_device on the resident fleet "
          f"{size / tv_s:.2f} checkpoints/s; host "
          f"merge_weights {float(np.mean(host_s)):.4f} s "
          f"per checkpoint ({1 / float(np.mean(host_s)):.4f} "
          f"checkpoints/s); every member within 4 ulp of the host path "
          f"[{card}]")

    host_regmean = host_regmean()
    state = merging_device.stack_checkpoints([sd_moe])
    grams32 = {k: torch.from_numpy(v).to(dev).float()
               for k, v in grams64.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = merging_device.regmean_device(state, grams32,
                                        scaling_for_non_diag=NON_DIAG, **kw)
    torch.cuda.synchronize()
    regmean_s = time.perf_counter() - t0
    if set(got) != set(host_regmean):
        fail("regmean_device: keys differ from the host regmean's")
    checks_t0 = time.perf_counter()
    worst = {}
    for k, h in host_regmean.items():
        want = torch.from_numpy(h).to(dev).double()
        err = float((got[k][0].double() - want).abs().max())
        m = re.match(r"(transformer\.blocks\.(\d+)\.(attn|mlp))\."
                     r"(qkv|proj|fc1|fc2)\.weight$", k)
        # the v and l grams: the attention input for qkv, else the module's
        names = [] if m is None else [
            f"{m.group(1)}.{e}" + ("" if m.group(4) == "qkv" else
                                   f".{m.group(4)}") for e in "vl"]
        if not names or not all(n in grams64 for n in names):
            # averaged, or passed through (a shared module of a partial
            # mode): f32 sums and divisions
            tol = 4 * float(np.spacing(np.float32(max(
                float(want.abs().max()), 1.0))))
            if err > tol:
                fail(f"regmean_device {k}: max |Δ| {err} > 4 ulp {tol}")
            continue
        summed = sum(NON_DIAG * torch.from_numpy(grams64[n]).to(dev)
                     + (1 - NON_DIAG) * torch.diag(torch.diag(
                         torch.from_numpy(grams64[n]).to(dev)))
                     for n in names)
        # κ = λmax / λmin: λmax by f32 eigvalsh, λmin as the reciprocal of
        # the largest eigenvalue of the inverse, the inverse taken in f64
        # (Cholesky) and its eigenvalues in f32; a largest eigenvalue in
        # f32 is within about D·2^-24 of itself, so κ is within about
        # 2·D·2^-24 whatever λmin, without f64 eigvalsh's seconds at D =
        # 4096
        chol, info = torch.linalg.cholesky_ex(summed)
        if int(info) != 0:
            fail(f"regmean {k}: summed gram not positive definite")
        kappa = float(torch.linalg.eigvalsh(summed.float())[-1]) * float(
            torch.linalg.eigvalsh(torch.cholesky_inverse(chol).float())[-1])
        rel = err / float(want.abs().max())
        bound = regmean_bound(summed.shape[0], kappa)
        limit = REGMEAN_MEASURED_SHARE * bound
        print(f"regmean_device {k}: gram dim {summed.shape[0]}, condition "
              f"number {kappa:.4e}, relative drift {rel:.4e} (bound "
              f"{bound:.4e}, limit {limit:.4e})")
        kind = m.group(4)
        worst[kind] = max(worst.get(kind, (0.0,)), (rel / bound, kappa, rel))
        if rel > bound:
            fail(f"regmean_device {k}: relative drift {rel} > {bound} "
                 f"(κ {kappa})")
        if rel > limit:
            fail(f"regmean_device {k}: relative drift {rel} > "
                 f"{REGMEAN_MEASURED_SHARE} of its bound, {limit} "
                 f"(κ {kappa})")
    print(f"{label}: regmean_device (one checkpoint, f32 solve): "
          f"{regmean_s:.3f} s (its checks, κ included, "
          f"{time.perf_counter() - checks_t0:.1f} s); limit "
          f"{REGMEAN_MEASURED_SHARE} of the bound; "
          f"worst drift / bound by weight "
          + ", ".join(f"{k} {v[0]:.4f} (κ {v[1]:.4e}, drift {v[2]:.4e})"
                      for k, v in sorted(worst.items())) + f" [{card}]")


def merge_cli(names, method: str, moe_path: str, central_path: str,
              gram_path: str, tmp: Path) -> tuple:
    """``merge.py`` of the checkpoint ``moe_path`` (config ``names``) by
    ``method``: interpolation, task arithmetic (around
    ``central_path``) or RegMean (the grams at ``gram_path``); returns
    (the merged checkpoint's path, seconds)."""
    extra = {"merge_weights": ["merge_weights=True",
                               f"merge_ratio={MERGE_RATIO}"],
             "sum_task_vectors": ["sum_task_vectors=True",
                                  f"sum_lambda={SUM_LAMBDA}",
                                  f"central_weight={central_path!r}"],
             "regmean": ["regmean=True", f"scaling_for_non_diag={NON_DIAG}",
                         f"gram_matrices={gram_path!r}"]}[method]
    t0 = time.perf_counter()
    out = merge.main(["with", *names, f"load_path={moe_path!r}",
                      f"log_dir={str(tmp / method)!r}", *extra])
    return out, time.perf_counter() - t0


def merge_methods(names, ufo_names, moe_path: str, central_path: str,
                  gram_path: str, dev, eval_set, tmp: Path,
                  device_merging) -> dict:
    """``merge_cli`` by each method, each merged checkpoint read by
    ``load_params`` into the ufo config ``ufo_names`` and scored by
    ``check_merged_eval``.  RegMean (the
    host's f64 solves) runs in a thread beside the other two methods and
    ``device_merging``, which is called with a function that waits for the
    host RegMean checkpoint and reads it.  Returns the evals' launches."""
    ucfg = build_config(*ufo_names)
    uspec = make_model_spec(ucfg)
    counts = dict.fromkeys(KERNELS, 0)

    def score(method: str, out: str, merge_s: float) -> None:
        nonlocal counts
        lcfg = build_config(*ufo_names, overrides=dict(load_path=out,
                                                      test_only=True))
        t0 = time.perf_counter()
        merged, missing, unexpected = load_params(lcfg, uspec)
        load_s = time.perf_counter() - t0
        Path(out).unlink()
        beside = " in a thread beside the rest" if method == "regmean" \
            else ""
        print(f"merge.py {method} ({' + '.join(names)}): {merge_s:.2f} s on "
              f"the host (read, merge, write){beside}; load_params into ufo "
              f"{load_s:.2f} s, missing {missing}, unexpected {unexpected}")
        if missing or unexpected:
            fail(f"{method}: the merged checkpoint does not fill the ufo "
                 f"schema")
        n = check_merged_eval(merged, uspec, ucfg, dev,
                              f"{method}, {names[-1]}", eval_set)
        counts = {k: counts[k] + n[k] for k in KERNELS}

    paths = (moe_path, central_path, gram_path, tmp)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        regmean = pool.submit(merge_cli, names, "regmean", *paths)
        for method in ("merge_weights", "sum_task_vectors"):
            score(method, *merge_cli(names, method, *paths))
        device_merging(lambda: load_torch_checkpoint(regmean.result()[0]))
        score("regmean", *regmean.result())
    return counts


def run_merging(dev, card: str) -> dict:
    """The merging suite at full width over the COCO @384 all_moe
    checkpoint: write and read back, the gram pass, merge.py (three
    methods), ``load_params`` into ufo and the retrieval eval of each
    merged checkpoint, device merging."""
    cfg = build_config(*CONFIG_MOE)
    spec = make_model_spec(cfg)
    ucfg = build_config(*CONFIG)
    uspec = make_model_spec(ucfg)
    t0 = time.perf_counter()
    sd_moe = seeded_state(spec, SEED + 20)
    central = seeded_state(uspec, SEED + 21)
    print(f"seeded all_moe checkpoint: {len(sd_moe)} tensors, "
          f"{sum(v.size for v in sd_moe.values()) / 1e6:.1f} M parameters; "
          f"ufo central: {len(central)} tensors, "
          f"{sum(v.size for v in central.values()) / 1e6:.1f} M "
          f"({time.perf_counter() - t0:.1f} s on the host)")
    counts = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        moe_path, central_path = str(tmp / "moe.ckpt"), str(
            tmp / "central.ckpt")
        t0 = time.perf_counter()
        save_torch_checkpoint(sd_moe, moe_path)
        save_torch_checkpoint(central, central_path)
        back = (load_torch_checkpoint(moe_path),
                load_torch_checkpoint(central_path))
        io_s = time.perf_counter() - t0
        for name, sd, got in (("all_moe", sd_moe, back[0]),
                              ("central", central, back[1])):
            if set(got) != set(sd) or not all(bit_equal(got[k], sd[k])
                                              for k in sd):
                fail(f"the {name} checkpoint did not read back bit for bit")
        del back
        print(f"checkpoints written and read back bit for bit "
              f"(Lightning envelope): {io_s:.2f} s")

        # the gram pass over the all_moe model, f32 masters on the card
        params = params_from_numpy(sd_moe, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 22)
        images = torch.randn(GRAM_PAIRS, 3, spec.image_size, spec.image_size,
                             device=dev, generator=gen)
        ids, masks = synthetic_captions(spec, GRAM_PAIRS, dev, gen)
        batches = [{"image": images[i:i + GRAM_BATCH],
                    "text_ids": ids[i:i + GRAM_BATCH],
                    "text_masks": masks[i:i + GRAM_BATCH]}
                   for i in range(0, GRAM_PAIRS, GRAM_BATCH)]
        small = [{k: v[:GRAM_F64_PAIRS] for k, v in batches[0].items()}]
        _, f32_s, n1 = run_gram_pass(params, spec, cfg, batches,
                                     "f32_device", "f32_device, 64 pairs")
        g64, f64_s, n2 = run_gram_pass(params, spec, cfg, small, "f64_host",
                                       "f64_host, 8 pairs")
        g32, f32_8_s, n3 = run_gram_pass(params, spec, cfg, small,
                                         "f32_device", "f32_device, 8 pairs")
        # the forward with its taps alone (the card's share of each pass):
        # one batch of 32 under the f32 gram tap, 8 pairs under capture
        split = {}
        for name, make, batch in (("f32_device", make_gram_step, batches[0]),
                                  ("f64_host", make_capture_step, small[0])):
            step = make(cfg, spec)
            step(params, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, batch)
            torch.cuda.synchronize()
            split[name] = time.perf_counter() - t0
        del params
        for n in (n1, n2, n3):
            counts = {k: counts[k] + n[k] for k in KERNELS}
        flops = sum(2.0 * gram_rows(spec, k, GRAM_F64_PAIRS) * g.shape[0] ** 2
                    for k, g in g64.items())
        worst = 0.0
        for k, g in g64.items():
            # an f32 sum of rows products is within γ_rows·Σ|x_i x_j| of
            # the exact gram, and Σ|x_i x_j| ≤ max diag = max |g|
            bound = gram_rows(spec, k, GRAM_F64_PAIRS) * F32_EPS * \
                np.abs(g).max()
            err = np.abs(g32[k] - g).max()
            worst = max(worst, err / bound)
            if err > bound:
                fail(f"gram {k}: f32_device and f64_host differ by {err} > "
                     f"rows·2^-24·max|g| = {bound}")
        print(f"gram pass (irtr, all_moe, {len(g64)} grams, K2 "
              f"{spec.num_layers} per image batch, no K1/K3/K13): "
              f"f32_device {f32_s:.3f} s for {GRAM_PAIRS} pairs in batches "
              f"of {GRAM_BATCH}, {f32_8_s:.3f} s for {GRAM_F64_PAIRS}; "
              f"f64_host {f64_s:.3f} s for {GRAM_F64_PAIRS} pairs "
              f"({flops / 1e12:.3f} TFLOP of f64 xᵀx on the host, "
              f"{flops / f64_s / 1e9:.1f} GFLOP/s); the forward with its "
              f"taps alone {split['f32_device']:.3f} s per batch of "
              f"{GRAM_BATCH} (f32 grams on the card), "
              f"{split['f64_host']:.3f} s for {GRAM_F64_PAIRS} pairs "
              f"(capture), the rest copies and sums on the host; "
              f"f32_device vs f64_host "
              f"on the same pairs: worst |Δ| {worst:.4f} of its bound "
              f"rows·2^-24·max|g| [{card}]")
        del g32
        gram_path = str(tmp / "G.pth")
        save_gram_matrices(g64, gram_path)

        # host merging through the CLI, then ingest into ufo and score
        eval_set = synthetic_eval_set(uspec, dev, torch.Generator(
            device=dev).manual_seed(SEED + 23))

        def device_merging(host_regmean):
            run_ratio_sweep(sd_moe, spec, cfg["loss_names"], dev, card)
            run_device_merging(sd_moe, central, g64, host_regmean, spec, dev,
                               card, loss_names=cfg["loss_names"])

        n = merge_methods(
            CONFIG_MOE, CONFIG, moe_path, central_path, gram_path, dev,
            eval_set, tmp, device_merging)
        counts = {k: counts[k] + n[k] for k in KERNELS}
        del eval_set
    return counts


# --------------------------------------------------------------------------
# Phase 12: the fused VL pass and the downstream eval
# --------------------------------------------------------------------------

# VQA @480: the published fine-tune's eval size, which the task config
# (image_size 224) reaches by this override (bench.py:503-506), composed
# with ufo: layers 0-9 split per modality (40 text, 901 image tokens),
# layers 10-11 run the joint 941
CONFIG_VQA = ("task_finetune_vqa_square_randaug_base_image384_ufo", "ufo")
VQA_SIZE, VQA_BATCH, VQA_BATCHES = 480, 32, 2
CONFIG_NLVR2 = "task_finetune_nlvr2_square_randaug_base_image384"
CONFIG_NLVR2_224 = "task_finetune_nlvr2_square_randaug_base"
NLVR2_PAIRS = 32
# the ITM rerank of phase 4's COCO eval: each query's top 4, 64 pairs a
# fused pass (16 queries a chunk)
RERANK_TOPK, RERANK_PAIR_BATCH = 4, 64
# K2 alone at the image tower's and the fused passes' lengths
K2_LENGTHS = (577, 617, 941)


def vl_captions(spec, n, dev, gen):
    """n captions of 5 to 40 valid tokens (bench.py:514-518): caption
    padding leaves zeros inside a fused pass's key range."""
    T = spec.max_text_len
    ids = torch.randint(1000, spec.vocab_size, (n, T), device=dev,
                        generator=gen)
    lengths = torch.randint(5, T + 1, (n, 1), device=dev, generator=gen)
    return ids, (torch.arange(T, device=dev)[None] < lengths).to(torch.int32)


def check_cosine(label: str, got, want) -> float:
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: not finite")
    cos = min_cosine(got, want)
    print(f"{label}, kernels vs plain path: min cosine {cos:.6f} (need >= "
          f"{MIN_COSINE})")
    if cos < MIN_COSINE:
        fail(f"{label}: the kernel path disagrees with the plain path")
    return cos


def per_sec(fn, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def rates_in_turns(paths: dict, n: int) -> dict:
    """Each path's best rate of two, taken in the order a, b, ..., b, a."""
    rates = {k: [] for k in paths}
    for k in list(paths) + list(paths)[::-1]:
        rates[k].append(per_sec(paths[k], n))
    return {k: max(v) for k, v in rates.items()}


def vqa_batches(spec, dev) -> list:
    """The seeded VQA feeds: batches of questions (captions of 5 to 40
    valid tokens), images and question ids."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    out = []
    for i in range(VQA_BATCHES):
        ids, masks = vl_captions(spec, VQA_BATCH, dev, gen)
        out.append({"text_ids": ids, "text_masks": masks,
                    "image": torch.randn(VQA_BATCH, 3, spec.image_size,
                                         spec.image_size, device=dev,
                                         generator=gen),
                    "qid": list(range(i * VQA_BATCH, (i + 1) * VQA_BATCH))})
    return out


def run_vqa(dev, card: str) -> dict:
    """VQA @480 through ``vqa_predictions`` in bf16 ("tail") and in W8A8."""
    cfg = build_config(*CONFIG_VQA, overrides=dict(image_size=VQA_SIZE))
    spec = make_model_spec(cfg)
    if spec.max_text_len + spec.image_len != 941:
        fail(f"VQA @480 fuses {spec.max_text_len + spec.image_len} tokens, "
             f"expected 941")
    base = seeded_params(spec, dev)
    params = eval_cast_params(base, spec, cfg)
    batches = vqa_batches(spec, dev)
    n_q = VQA_BATCH * VQA_BATCHES
    id2answer = {i: f"answer {i}" for i in range(spec.vqav2_label_size)}
    launches = dict.fromkeys(KERNELS, 0)

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rets = downstream.vqa_predictions(params, spec, batches, id2answer)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = check_launches(
        f"VQA @480 bf16 'tail', {VQA_BATCHES} batches of {VQA_BATCH}",
        scaled(fused_pass_launches(spec, VQA_BATCH, "tail", train=False),
               VQA_BATCHES))
    launches = {k: launches[k] + got[k] for k in KERNELS}
    print(f"vqa_predictions (VQA @480, bf16): {seconds:.3f} s for {n_q} "
          f"questions (the first call: the bias gather of ten split and two "
          f"joint layers included)")
    if downstream.vqa_predictions(params, spec, batches, id2answer,
                                  scan_k=2) != rets:
        fail("vqa_predictions: scan_k 2 and 1 give different answers")
    with tempfile.TemporaryDirectory() as tmp:
        path = downstream.write_vqa_submission(rets, "chip_smoke", tmp)
        records = json.loads(Path(path).read_text())
    if [r["question_id"] for r in records] != list(range(n_q)):
        fail(f"the VQA submission holds {len(records)} records")
    print(f"VQA submission: {len(records)} records written, scan_k 2 gives "
          f"scan_k 1's answers")
    logits_k = torch.cat([downstream.vqa_logits(params, spec, b)
                          for b in batches])
    logits_p = torch.cat([downstream.vqa_logits(params, spec, b,
                                                kernels=False)
                          for b in batches])
    if logits_k.shape != (n_q, spec.vqav2_label_size):
        fail(f"VQA logits of shape {tuple(logits_k.shape)}")
    check_cosine("VQA @480 bf16 logits", logits_k, logits_p)

    cfg8 = build_config(*CONFIG_VQA, overrides=dict(image_size=VQA_SIZE,
                                                    eval_int8=True))
    spec8 = make_model_spec(cfg8)
    params8 = eval_cast_params(base, spec8, cfg8)
    del base
    reset_launches()
    rets8 = downstream.vqa_predictions(params8, spec8, batches, id2answer)
    got = check_launches(
        f"VQA @480 W8A8, {VQA_BATCHES} batches of {VQA_BATCH}",
        scaled(fused_pass_launches(spec8, VQA_BATCH, train=False, int8=True),
               VQA_BATCHES))
    launches = {k: launches[k] + got[k] for k in KERNELS}
    logits8 = torch.cat([downstream.vqa_logits(params8, spec8, b)
                         for b in batches])
    with int8_plain_path():
        logits8_p = torch.cat([downstream.vqa_logits(params8, spec8, b)
                               for b in batches])
    check_cosine("VQA @480 W8A8 logits (the int8 plain path)", logits8,
                 logits8_p)
    same = sum(a == b for a, b in zip(rets8, rets))
    print(f"VQA @480 W8A8 against bf16 (no gate): {same} of {n_q} answers "
          f"equal, logits min cosine {min_cosine(logits8, logits_k):.6f}")

    def answers(p, s, kernels=True):
        return lambda: downstream.vqa_predictions(p, s, batches, id2answer,
                                                  kernels=kernels)

    rates = rates_in_turns({"bf16 plain": answers(params, spec, False),
                            "bf16 kernels": answers(params, spec),
                            "W8A8 kernels": answers(params8, spec8)}, n_q)
    print(f"VQA @480 (ViT-B/16, batch {VQA_BATCH}, {n_q} questions a call, "
          f"the bias gather included): "
          + ", ".join(f"{k} {v:.1f} questions/s" for k, v in rates.items())
          + f" (best of 2, in turns) [{card}]")
    return launches


def nlvr2_batch(spec, dev, gen, n: int) -> dict:
    ids, masks = vl_captions(spec, n, dev, gen)
    size = spec.image_size
    return {"text_ids": ids, "text_masks": masks,
            "image_0": torch.randn(n, 3, size, size, device=dev,
                                   generator=gen),
            "image_1": torch.randn(n, 3, size, size, device=dev,
                                   generator=gen),
            "answers": torch.randint(0, 2, (n,), device=dev, generator=gen)}


@torch.no_grad()
def pair_feats(params, spec, batch, **route):
    """The paired pass's concatenated cls features (B, 2C)."""
    return torch.cat([model.infer(params, spec, batch,
                                  image_token_type_idx=i, **route)
                      ["cls_feats"] for i in (1, 2)], dim=-1)


def run_nlvr2(dev, card: str) -> dict:
    """NLVR2 @384 (ufo and all_moe) and @224 through ``compute_losses(...,
    train=False)``, the split and metrics; the @384 fused pass by each
    ``fusion``."""
    launches = dict.fromkeys(KERNELS, 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    tables = [f"{'dev' if i % 2 else 'test1'}-{i}" for i in range(NLVR2_PAIRS)]
    for name, mode in ((CONFIG_NLVR2, "ufo"), (CONFIG_NLVR2, "all_moe"),
                       (CONFIG_NLVR2_224, "ufo")):
        cfg = build_config(name, mode)
        spec = make_model_spec(cfg)
        params = eval_cast_params(seeded_params(spec, dev), spec, cfg)
        batch = nlvr2_batch(spec, dev, gen, NLVR2_PAIRS)
        at = f"NLVR2 @{spec.image_size} {mode}, {NLVR2_PAIRS} pairs"
        reset_launches()
        with torch.no_grad():
            out = train_step.compute_losses(params, spec, cfg, batch, None,
                                            train=False)
        # two fused passes; @224 every block is below KERNEL_MIN_N (197
        # image, 237 joint tokens): the composed path, its attention
        # through K11 (B=32) and its MLP through K13 (the text half's too)
        got = check_launches(at, scaled(fused_pass_launches(
            spec, NLVR2_PAIRS, "tail", train=False), 2))
        launches = {k: launches[k] + got[k] for k in KERNELS}
        acc = metrics.MetricAccumulator()
        acc.update({k: out[k] for k in ("nlvr2_correct", "nlvr2_count",
                                         "nlvr2_loss")})
        downstream.nlvr2_split_update(acc, out["nlvr2_logits"],
                                      batch["answers"], tables)
        computed = acc.compute()
        print(f"{at}: nlvr2_correct {int(out['nlvr2_correct'])} of "
              f"{out['nlvr2_count']}, loss {float(out['nlvr2_loss']):.4f}; "
              f"metrics {json.dumps(computed)}; the_metric "
              f"{metrics.the_metric({'nlvr2': 1}, computed):.4f}")
        split = acc.sums["dev_nlvr2_correct"] + acc.sums["test_nlvr2_correct"]
        if not np.isfinite(float(out["nlvr2_loss"])) or \
                split != float(out["nlvr2_correct"]):
            fail(f"{at}: the loss is not finite or the dev/test split "
                 f"({split}) disagrees with nlvr2_correct")
        check_cosine(f"{at}: paired cls features",
                     pair_feats(params, spec, batch),
                     pair_feats(params, spec, batch, kernels=False))

        def preds(kernels):
            return lambda: downstream.nlvr2_predictions(
                params, spec, [batch], kernels=kernels)

        rates = rates_in_turns({"plain": preds(False),
                                "kernels": preds(True)}, NLVR2_PAIRS)
        print(f"{at}: " + ", ".join(f"{k} {v:.1f} pairs/s"
                                    for k, v in rates.items())
              + f" (best of 2, in turns) [{card}]")
        if (name, mode) == (CONFIG_NLVR2, "ufo"):
            launches = run_fused_routes(params, spec, batch, launches)
    return launches


def run_fused_routes(params, spec, batch, launches: dict) -> dict:
    """The @384 fused pass (N = 617 in the deep layers) by each ``fusion``:
    its launches, and every route's hidden states bit-equal to "tail"'s."""
    out = {}
    for fusion in fb_ops.FUSIONS:
        reset_launches()
        with torch.no_grad():
            o = model.infer(params, spec, batch, fusion=fusion)
        got = check_launches(f"fused pass @384 by {fusion!r}",
                             fused_pass_launches(spec, batch["text_ids"]
                                                 .shape[0], fusion,
                                                 train=False))
        launches = {k: launches[k] + got[k] for k in KERNELS}
        out[fusion] = torch.cat([o["text_feats"], o["image_feats"]], dim=1)
    equal = {f: torch.equal(out[f], out["tail"]) for f in fb_ops.FUSIONS}
    print(f"fused pass @384: hidden states bit-equal to 'tail': {equal} "
          f"(K7 and K8 at N=617 in the deep layers)")
    if not all(equal.values()):
        fail(f"a fusion route of the fused pass differs from 'tail': {equal}")
    return launches


def run_rerank(dev, card: str) -> dict:
    """The ITM rerank of phase 4's COCO @384 eval (the config with its ITM
    head): ``compute_irtr_recall(itm_rerank_topk=4)``."""
    cfg = build_config(*CONFIG, overrides=dict(loss_names={"irtr": 1,
                                                           "itm": 1}))
    spec = make_model_spec(cfg)
    params = eval_cast_params(seeded_params(spec, dev), spec, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    text_batches, image_batches, tiids, iids = synthetic_eval_set(
        spec, dev, gen)
    chunk = RERANK_PAIR_BATCH // RERANK_TOPK
    chunks = -(-len(iids) // chunk) + -(-len(tiids) // chunk)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recall = compute_irtr_recall(params, spec, text_batches, image_batches,
                                 tiids, iids, itm_rerank_topk=RERANK_TOPK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    per_chunk = fused_pass_launches(spec, RERANK_PAIR_BATCH, "tail",
                                    train=False)
    L = spec.num_layers
    towers = sum((block_launches(N, b["image"].shape[0], L, "tail",
                                 train=False) for b in image_batches),
                 collections.Counter()) + sum(
        (block_launches(spec.max_text_len, b["text_ids"].shape[0], L,
                        train=False) for b in text_batches),
        collections.Counter())
    got = check_launches(
        f"ITM rerank (top {RERANK_TOPK}, {chunks} chunks of {chunk} "
        f"queries: {per_chunk['ln_linear']} K1-K3 and {per_chunk['mlp']} "
        f"K13 a chunk, beside the towers)",
        towers + scaled(per_chunk, chunks))
    print(f"compute_irtr_recall with the ITM rerank: {seconds:.3f} s wall for "
          f"{len(iids)} images, {len(tiids)} captions, {chunks} fused passes "
          f"of {RERANK_PAIR_BATCH} pairs [{card}]; recall "
          + json.dumps(recall))
    if not all(0.0 <= v <= 1.0 for v in recall.values()):
        fail(f"rerank recall out of range: {recall}")

    with torch.no_grad():
        img = extract_features(params, spec, image_batches, "image")
        txt = extract_features(params, spec, text_batches, "text")
    ids = torch.cat([b["text_ids"] for b in text_batches])
    masks = torch.cat([b["text_masks"] for b in text_batches])
    images = torch.cat([b["image"] for b in image_batches])
    scores = img.float() @ txt.float().T
    for axis, label in ((1, "text retrieval"), (0, "image retrieval")):
        s_k, s_p = (itm_rerank_scores(params, spec, ids, masks, images,
                                      scores, RERANK_TOPK, axis=axis,
                                      kernels=kernels)
                    for kernels in (True, False))
        picked = s_k > -1e7
        if not torch.equal(picked, s_p > -1e7):
            fail(f"rerank ({label}): the candidates differ between paths")
        k, p = s_k[picked] / 1e4, s_p[picked] / 1e4
        cos = float(F.cosine_similarity(k, p, dim=0))
        print(f"rerank ({label}): {int(picked.sum())} ITM log-probabilities, "
              f"kernels vs plain path: cosine {cos:.6f} (need >= "
              f"{MIN_COSINE}), max |Δ| {float((k - p).abs().max()):.3e}")
        if cos < MIN_COSINE or not bool(torch.isfinite(k).all()):
            fail(f"rerank ({label}): the kernel path disagrees")
    return got


def joint_mask(n: int, dev, gen, batch: int = IMAGE_BATCH):
    """A fused pass's key mask over n tokens: 40 caption tokens of which 5
    to 40 are valid (zeros inside the key range), then the image's
    ones."""
    mask = torch.ones(batch, n, dtype=torch.int32, device=dev)
    lengths = torch.randint(5, 41, (batch, 1), device=dev, generator=gen)
    mask[:, :40] = (torch.arange(40, device=dev)[None] < lengths).to(
        torch.int32)
    return mask


def check_joint_attention(dev, rows, card: str, heads: int = HEADS,
                          lengths=K2_LENGTHS) -> None:
    """K2 alone (``heads`` heads of 64) at the image tower's length (577,
    a mask of ones) and the fused passes' (617, 941; the joint mask, zeros
    inside), and at 12 heads K11 and K10 at the @224 fused pass's (237,
    the joint mask): against their twin, timed beside SDPA and their
    bound; their rows of the kernels line take them under ``at_n`` (at
    other than 12 heads ``at_n_h{heads}``)."""
    suffix = "" if heads == HEADS else f"_h{heads}"
    gen = torch.Generator(device=dev).manual_seed(
        SEED + 32 + (0 if heads == HEADS else heads))
    out = {}
    for n in lengths:
        qkv = torch.randn(IMAGE_BATCH, n, 3 * 64 * heads, device=dev,
                          generator=gen).bfloat16()
        bias = torch.randn(heads, n, n, device=dev, generator=gen)
        mask = torch.ones(IMAGE_BATCH, n, dtype=torch.int32, device=dev) \
            if n == N else joint_mask(n, dev, gen)
        args = (qkv, bias, mask, 64 ** -0.5, heads)
        got = attn_ops.packed_attention(*args)
        want = attn_ops.packed_attention_reference(*args)
        torch.cuda.synchronize()
        max_err, worst, differ = ulp_check("packed_attention", got, want)
        ms = time_ms(lambda: attn_ops.packed_attention(*args))
        plain_ms = time_ms(lambda: attn_ops.packed_attention_reference(
            *args), iters=TIMED_ITERS // 2)
        library_ms = time_ms(library_call("packed_attention", args))
        bound_ms, bound_by = bound(*work("packed_attention", args))
        out[n] = ms
        print(f"packed_attention at N={n} (B={IMAGE_BATCH}, {heads} heads, "
              f"{'ones' if n == N else 'joint mask, ' + str(int((mask == 0).sum())) + ' zeros inside'}): "
              f"max |kernel - twin| = {max_err:.6g}, worst err/bound = "
              f"{worst:.3f}, {differ:.3e} of the elements differ; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
        if not bool(torch.isfinite(got).all()) or worst > 1.0:
            fail(f"packed_attention disagrees with its twin at N={n}, "
                 f"{heads} heads")
        if 64 * heads not in rows["packed_attention"].setdefault("widths",
                                                               []):
            rows["packed_attention"]["widths"].append(64 * heads)
        rows["packed_attention"][f"at_{n}{suffix}"] = {
            "max_abs_err": max_err, "worst_err_over_bound": worst,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "heads": heads}
    first = lengths[0]
    print(f"packed_attention ({heads} heads) against N={first}: " + ", ".join(
        f"N={n} {out[n] / out[first]:.3f} x" for n in lengths[1:])
        + f" [{card}]")
    if heads != HEADS:
        return
    # K11 and K10 at the @224 fused pass's joint length: the pretrain's 32
    # pairs and the VQA fine-tune's 30 questions
    n = JOINT_N_224
    for name, b in (("split_attention_bb", PRETRAIN_PAIRS),
                    ("split_attention", VQA_TRAIN_BATCH)):
        qkv = torch.randn(b, n, 3 * C, device=dev, generator=gen).bfloat16()
        q, k, v = qkv.view(b, n, 3, HEADS, 64).permute(2, 0, 3, 1, 4)
        mask = joint_mask(n, dev, gen, batch=b)
        args = (q, k, v, torch.randn(HEADS, n, n, device=dev, generator=gen),
                mask, 64 ** -0.5)
        kernel, twin = KERNELS[name][:2]
        got, want = kernel(*args), twin(*args)
        torch.cuda.synchronize()
        max_err, worst, differ = ulp_check(name, got, want)
        ms = time_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: twin(*args), iters=TIMED_ITERS // 2)
        library_ms = time_ms(library_call(name, args))
        bound_ms, bound_by = bound(*work(name, args))
        print(f"{name} at N={n} (B={b}, joint mask, "
              f"{int((mask == 0).sum())} zeros inside): max |kernel - twin| "
              f"= {max_err:.6g}, worst err/bound = {worst:.3f} (bound "
              f"{ULPS[name]} bf16 ulps), {differ:.3e} of the elements "
              f"differ; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
              f"[{card}]")
        if not bool(torch.isfinite(got).all()) or worst > 1.0:
            fail(f"{name} disagrees with its twin at N={n} under the joint "
                 f"mask")
        rows[name][f"at_{n}"] = {
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def run_vl(dev, card: str, rows: dict) -> dict:
    """Phase 12: VQA @480 (bf16, W8A8), NLVR2 @384 and @224, the fused
    pass by route, the ITM rerank, K2 at the joint lengths."""
    counts = [run_vqa(dev, card), run_nlvr2(dev, card), run_rerank(dev, card)]
    check_joint_attention(dev, rows, card)
    return {k: sum(c[k] for c in counts) for k in KERNELS}


# --------------------------------------------------------------------------
# Phase 13: the training objectives
# --------------------------------------------------------------------------

# (a) the NLVR2 @384 fine-tune: micro-batches of 16 pairs, 2 a step (its
# two fused passes of 617 tokens a pair)
CONFIG_NLVR2_TRAIN = (CONFIG_NLVR2, "ufo")
NLVR2_MICRO, NLVR2_ACCUM = 16, 2
# (b) the VLMo pretrain @224: mlm, ifm (both towers, both vlffn re-runs)
# and itm (three fused passes of 40 + 197 = 237 tokens)
CONFIG_PRETRAIN = ("task_mlm_itm_ifm_square_randaug_base", "all_moe")
PRETRAIN_PAIRS = 32
# (c) the all-in-one pretrain: 16 images, 16 texts and 16 pairs a step
CONFIG_ALL_IN_ONE = ("task_all_in_one_pretraining",)
MIXED_BATCH = 16
# (d) the VQA fine-tune at its config's own 224 (a batch of 30: a ragged
# batch takes K10), the ImageNet @384 fine-tune (32 images), and "adam"
# and "sgd" on the latter
CONFIG_IMAGENET = ("task_finetune_imagenet_square_randaug_base_image384",)
VQA_TRAIN_BATCH, IMAGENET_BATCH = 30, 32
# the MIM targets' masked share (BEiT's 75 of 196 patches)
MIM_MASKED = 0.4
# the dVAE gate: the card's codebook ids against the CPU f32 encoder's on
# DVAE_CPU_IMAGES targets: at least DVAE_MIN_EQUAL equal, and every id
# that differs a near tie, its CPU top-2 logit gap below DVAE_TIE of the
# logit scale (the largest |logit|): cuDNN sums in another order
DVAE_CPU_IMAGES, DVAE_MIN_EQUAL, DVAE_TIE = 4, 0.99, 1e-3


class Negatives:
    """``objectives.sample_hard_negatives`` that draws (the generator
    advances as always) and, after ``rewind``, returns the draws of the
    first run in their order: two paths whose ifm logits differ in the
    last bits train on the same negatives."""

    def __init__(self):
        self.real = objectives.sample_hard_negatives
        self.drawn, self.at, self.replaying = [], 0, False

    def __call__(self, sim_i2t, sim_t2i, generator):
        out = self.real(sim_i2t, sim_t2i, generator)
        if not self.replaying:
            self.drawn.append(out)
            return out
        self.at += 1
        return self.drawn[self.at - 1]

    def rewind(self) -> None:
        self.replaying, self.at = True, 0


@contextlib.contextmanager
def replayed_negatives():
    negatives = Negatives()
    objectives.sample_hard_negatives = negatives
    try:
        yield negatives
    finally:
        objectives.sample_hard_negatives = negatives.real


def against_plain(label: str, cfg, spec, base, mb, dev, *,
                  fusions=("0",), mim_label_fn=None) -> None:
    """The kernel path's losses and gradients (each training fusion in
    ``fusions``) against the plain path's on one micro-batch, the same
    params, draws and ITM negatives: each loss within LOSS_REL relative,
    the loss vector's and the gradients' global cosines at least
    MIN_COSINE, every loss and gradient finite (dbias of rows whose keys
    are all masked included)."""
    params = master_params(base)
    runs = {}
    with replayed_negatives() as negatives:
        for key in fusions + ("plain",):
            g = torch.Generator(device=dev).manual_seed(SEED + 40)
            _, metrics, grads = train_step.loss_and_grads(
                params, spec, cfg, mb, g, kernels=key != "plain",
                train_fusion="0" if key == "plain" else key,
                mim_label_fn=mim_label_fn)
            losses = {k: float(v) for k, v in metrics.items()
                      if k.endswith("_loss")}
            bad = [k for k, v in grads.items()
                   if not bool(torch.isfinite(v).all())]
            if bad or not all(np.isfinite(v) for v in losses.values()):
                fail(f"{label} ({key}): a loss or the gradients of "
                     f"{bad[:4]} not finite: {losses}")
            runs[key] = (losses, grads)
            negatives.rewind()
    plain_losses, plain_grads = runs.pop("plain")
    for key, (losses, grads) in runs.items():
        a = torch.tensor([losses[k] for k in plain_losses], dtype=torch.float64)
        b = torch.tensor(list(plain_losses.values()), dtype=torch.float64)
        loss_cos = float(F.cosine_similarity(a, b, dim=0))
        rel = float(((a - b).abs() / b.abs()).max())
        cos = global_cosine(grads, plain_grads)
        leaf = min((float(F.cosine_similarity(
            grads[k].flatten().double(), plain_grads[k].flatten().double(),
            dim=0)), k) for k in grads if plain_grads[k].any())
        print(f"{label}, {'kernel path' if key == '0' else repr(key)} vs "
              f"plain path: losses {losses} (plain {plain_losses}), loss "
              f"cosine {loss_cos:.6f}, worst relative difference {rel:.2e} "
              f"(need <= {LOSS_REL}); gradients global cosine {cos:.6f} "
              f"(need >= {MIN_COSINE}), worst leaf {leaf[0]:.6f} "
              f"({leaf[1]})")
        if rel > LOSS_REL or loss_cos < MIN_COSINE or cos < MIN_COSINE:
            fail(f"{label} ({key}): the kernel path disagrees with the "
                 f"plain path")


def train_in_turns(label: str, runs: dict, batch, examples: int,
                   want: dict, card: str, unit: str = "pairs") -> dict:
    """One warm-up step of each run ({key: (state, step)}, updated in
    place), then TIMED_STEPS steps of each in turns (a, b, ..., b, a),
    every loss and the grad norm finite; each run's launches over its
    TRAIN_STEPS steps against ``want[key]`` a step (a run not in ``want``,
    the plain path, launches none); each run's best timed step ms,
    examples/s and peak memory.  Returns every run's launches, by kernel."""
    keys = list(runs)
    order = keys + [k for i in range(TIMED_STEPS)
                    for k in (keys if i % 2 else keys[::-1])]
    times = {k: [] for k in keys}
    peak = dict.fromkeys(keys, 0)
    got = {k: collections.Counter() for k in keys}
    for i, which in enumerate(order):
        state, step = runs[which]
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        state, metrics, ms = timed_step(step, state, batch)
        got[which] += launches_now()
        runs[which] = (state, step)
        warm_up = i < len(keys)
        if not warm_up:
            times[which].append(ms)
            peak[which] = max(peak[which], torch.cuda.max_memory_allocated())
        losses = {k: float(v) for k, v in metrics.items()
                  if k.endswith("_loss") or k == "grad_norm"}
        print(f"{label}, {which} path, "
              + ("warm-up step" if warm_up else f"step {len(times[which])}")
              + ": " + ", ".join(f"{k} {v:.6f}" for k, v in losses.items())
              + f", {ms:.1f} ms")
        if not all(np.isfinite(v) for v in losses.values()):
            fail(f"{label} ({which}): a loss or the grad norm not finite")
    total = dict.fromkeys(KERNELS, 0)
    for which in keys:
        counts = check_launches(
            f"{label}, {which} path, {TRAIN_STEPS} steps",
            scaled(want.get(which, collections.Counter()), TRAIN_STEPS),
            got[which])
        total = {k: total[k] + counts[k] for k in KERNELS}
    for which in keys:
        ms = min(times[which])
        print(f"{label} ({which} path): {ms:.1f} ms a step, "
              f"{1e3 * examples / ms:.1f} {unit}/s, peak memory "
              f"{peak[which] / 2**30:.2f} GiB (best of {TIMED_STEPS} after a "
              f"warm-up step, in turns) [{card}]")
    return total


def objective_runs(names, spec, base, steps: int, *, plain: bool = True,
                   fusions=("0",), mim_label_fn=None, **over) -> dict:
    """{"kernels": (state, step), "tail": ..., "full": ..., "plain": ...}:
    ``build_train_step`` of the config from the same masters, with the
    kernel switch (``pallas_attention``) on under each training fusion in
    ``fusions`` ("kernels" is "0"), and off."""
    out = {}
    for fusion in fusions + (("plain",) if plain else ()):
        kernels = fusion != "plain"
        cfg = build_config(*names, overrides=dict(
            over, warmup_steps=0, pallas_attention=kernels))
        out["kernels" if fusion == "0" else fusion] = build_train_step(
            cfg, spec, master_params(base), steps,
            train_fusion=fusion if kernels else "0",
            mim_label_fn=mim_label_fn)
    return out


def masked_captions(spec, n: int, dev, gen) -> dict:
    """n captions of 5 to 40 valid tokens with their MLM ids and labels:
    15% of the valid tokens and token 1 masked (id 103), -100 elsewhere."""
    ids, masks = vl_captions(spec, n, dev, gen)
    picked = (torch.rand(ids.shape, device=dev, generator=gen) < 0.15) & \
        (masks > 0)
    picked[:, 1] = True
    return {"text_ids": ids, "text_masks": masks,
            "text_ids_mlm": torch.where(picked, 103, ids),
            "text_labels_mlm": torch.where(picked, ids, -100)}


def pretrain_batch(spec, cfg, n: int, dev, gen) -> dict:
    """n pairs for the pretrain objectives: masked captions, images, the
    MIM targets (``dvae_image_size`` pixels) and masked patches."""
    b = masked_captions(spec, n, dev, gen)
    size, target = spec.image_size, cfg["dvae_image_size"]
    b["image"] = torch.randn(n, 3, size, size, device=dev, generator=gen)
    b["image_target"] = 0.1 + 0.8 * torch.rand(n, 3, target, target,
                                                device=dev, generator=gen)
    b["image_masked_pos"] = torch.rand(n, spec.num_patches, device=dev,
                                       generator=gen) < MIM_MASKED
    return b


def run_nlvr2_train(dev, card: str) -> dict:
    """(a) the NLVR2 @384 fine-tune, steps of 2 x 16 pairs: in ufo the
    kernel path under "0", "tail" and "full" and the plain path in turns;
    in all_moe the kernel and plain paths in turns, the vl experts taking
    gradients."""
    over = dict(per_device_batch_size=NLVR2_MICRO,
                batch_size=NLVR2_MICRO * NLVR2_ACCUM)
    cfg = build_config(*CONFIG_NLVR2_TRAIN, overrides=over)
    spec = make_model_spec(cfg)
    if spec.max_text_len + spec.image_len != JOINT_N:
        fail(f"NLVR2 @384 joint length {spec.max_text_len + spec.image_len}"
             f", expected {JOINT_N}")
    accum = accum_steps(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    pairs = nlvr2_batch(spec, dev, gen, NLVR2_MICRO * accum)
    batch = {k: v.reshape(accum, NLVR2_MICRO, *v.shape[1:])
             for k, v in pairs.items()}
    mb = {k: v[0] for k, v in batch.items()}
    launches = collections.Counter()
    passes = 2 * accum   # a step: two fused passes a pair per micro-batch
    label = f"NLVR2 @384 fine-tune ({accum} x {NLVR2_MICRO} pairs)"
    fusions = ("0", "tail", "full")
    base = seeded_params(spec, dev)
    against_plain(f"{label}, ufo", cfg, spec, base, mb, dev, fusions=fusions)
    launches += train_in_turns(
        f"{label}, ufo", objective_runs(CONFIG_NLVR2_TRAIN, spec, base,
                                        TRAIN_STEPS, fusions=fusions, **over),
        batch, NLVR2_MICRO * accum,
        {"kernels" if f == "0" else f: scaled(
            fused_pass_launches(spec, NLVR2_MICRO, f), passes)
         for f in fusions}, card)
    del base
    moe = (CONFIG_NLVR2, "all_moe")
    spec = make_model_spec(build_config(*moe, overrides=over))
    base = seeded_params(spec, dev)
    against_plain(f"{label}, all_moe", build_config(*moe, overrides=over),
                  spec, base, mb, dev)
    runs = objective_runs(moe, spec, base, TRAIN_STEPS, **over)
    launches += train_in_turns(
        f"{label}, all_moe", runs, batch, NLVR2_MICRO * accum,
        {"kernels": scaled(fused_pass_launches(spec, NLVR2_MICRO), passes)},
        card)
    vl = [k for k in base if ".vl." in k and k.endswith(".weight")]
    moved = sum(not torch.equal(runs["kernels"][0].params[k], base[k])
                for k in vl)
    print(f"{label}, all_moe: {moved} of the {len(vl)} vl-expert weights "
          f"moved in the steps")
    if moved != len(vl):
        fail(f"{label}, all_moe: the vl experts took no gradient")
    return dict(launches)


def run_pretrain(dev, card: str) -> dict:
    """(b) the VLMo pretrain @224 (mlm, ifm, itm) of 32 pairs, in all_moe
    and in ufo: the kernel and plain paths in turns."""
    launches = collections.Counter()
    for mode in ("all_moe", "ufo"):
        names = (CONFIG_PRETRAIN[0], mode)
        over = dict(per_device_batch_size=PRETRAIN_PAIRS,
                    batch_size=PRETRAIN_PAIRS)
        cfg = build_config(*names, overrides=dict(over,
                                                  pallas_attention=True))
        spec = make_model_spec(cfg)
        if spec.max_text_len + spec.image_len != JOINT_N_224:
            fail(f"the pretrain's joint length "
                 f"{spec.max_text_len + spec.image_len}, expected "
                 f"{JOINT_N_224}")
        gen = torch.Generator(device=dev).manual_seed(SEED + 43)
        batch = pretrain_batch(spec, cfg, PRETRAIN_PAIRS, dev, gen)
        base = seeded_params(spec, dev)
        label = (f"VLMo pretrain @{spec.image_size} {mode} (mlm, ifm, itm; "
                 f"{PRETRAIN_PAIRS} pairs)")
        against_plain(label, cfg, spec, base, batch, dev)
        launches += train_in_turns(
            label, objective_runs(names, spec, base, TRAIN_STEPS, **over),
            batch, PRETRAIN_PAIRS,
            {"kernels": pretrain_launches(spec, PRETRAIN_PAIRS)}, card)
        del base
    return dict(launches)


def check_dvae(enc_path: str, label_fn, targets, card: str) -> None:
    """The card's codebook ids (``label_fn``, the encoder read from
    ``enc_path``) against the CPU f32 encoder's on the first
    DVAE_CPU_IMAGES targets."""
    host = dvae.load_encoder_params(enc_path)
    x = targets[:DVAE_CPU_IMAGES]
    t0 = time.perf_counter()
    got = label_fn({"image_target": x}).cpu()
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits = dvae.encoder_logits(host, x.cpu())
    cpu_s = time.perf_counter() - t0
    want = logits.argmax(dim=1).reshape(x.shape[0], -1)
    top2 = logits.topk(2, dim=1).values
    gap = (top2[:, 0] - top2[:, 1]).reshape(x.shape[0], -1)
    scale = float(logits.abs().max())
    differ = got != want
    share = 1.0 - float(differ.float().mean())
    gaps = gap[differ]
    print(f"dVAE codebook ids on the card vs the CPU f32 encoder "
          f"({x.shape[0]} targets of {x.shape[-1]} px, {want.numel()} ids, "
          f"vocabulary {logits.shape[1]}): {share:.4%} equal (need >= "
          f"{DVAE_MIN_EQUAL:.0%}); {int(differ.sum())} differ, their CPU "
          f"top-2 gaps {[f'{v:.3g}' for v in gaps.tolist()]} against "
          f"{DVAE_TIE} x the logit scale {scale:.4g}; card {card_s:.3f} s, "
          f"CPU {cpu_s:.3f} s [{card}]")
    if share < DVAE_MIN_EQUAL or bool((gaps >= DVAE_TIE * scale).any()):
        fail("the dVAE's codebook ids on the card disagree with the CPU "
             "f32 encoder's beyond near ties")


def run_all_in_one(dev, card: str) -> dict:
    """(c) the all-in-one pretrain: one step of a mixed batch (16 images:
    image_only_mim; 16 texts: text_only_mlm; 16 pairs: mlm, mim, ifm, itm),
    the MIM labels from the port's dVAE encoder, its seeded weights
    written to a file and read back; the dVAE gate."""
    b = MIXED_BATCH
    over = dict(per_device_batch_size=b, batch_size=b)
    cfg = build_config(*CONFIG_ALL_IN_ONE, overrides=dict(
        over, pallas_attention=True))
    spec = make_model_spec(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 44)
    batch = {k: pretrain_batch(spec, cfg, b, dev, gen)
             for k in ("v", "l", "vl")}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "encoder.pkl")
        torch.save(dvae.init_encoder_params(
            torch.Generator().manual_seed(SEED + 45)), path)
        label_fn = dvae.make_mim_label_fn(path)
        check_dvae(path, label_fn, batch["v"]["image_target"], card)
    label = (f"all-in-one pretrain @{spec.image_size} ({b} images, {b} "
             f"texts, {b} pairs)")
    base = seeded_params(spec, dev)
    against_plain(label, cfg, spec, base, batch, dev, mim_label_fn=label_fn)
    T, I = spec.max_text_len, spec.image_len
    want = (tower_launches(spec, I, b)                          # v: mim
            + tower_launches(spec, T, b)                        # l: mlm
            + scaled(fused_pass_launches(spec, b), 2)           # mlm, mim
            + tower_launches(spec, I, b, rerun=True)            # ifm
            + tower_launches(spec, T, b, rerun=True)
            + scaled(fused_pass_launches(spec, b), 3))          # itm
    return train_in_turns(
        label, objective_runs(CONFIG_ALL_IN_ONE, spec, base, TRAIN_STEPS,
                              mim_label_fn=label_fn, **over),
        batch, 3 * b, {"kernels": want}, card, unit="examples")


def run_finetunes(dev, card: str) -> dict:
    """(d) the VQA fine-tune @224 (30 questions), kernel and plain paths in
    turns; the ImageNet @384 fine-tune (32 images), the kernel path with
    "adamw", "adam" and "sgd" and the plain path with "adamw" in turns."""
    launches = collections.Counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 46)
    n = VQA_TRAIN_BATCH
    over = dict(per_device_batch_size=n, batch_size=n)
    cfg = build_config(*CONFIG_VQA, overrides=dict(
        over, pallas_attention=True))
    spec = make_model_spec(cfg)
    batch = masked_captions(spec, n, dev, gen)
    batch["image"] = torch.randn(n, 3, spec.image_size, spec.image_size,
                                 device=dev, generator=gen)
    batch["vqa_targets"] = torch.rand(n, spec.vqav2_label_size, device=dev,
                                      generator=gen) * (torch.rand(
        n, spec.vqav2_label_size, device=dev, generator=gen) < 0.002)
    label = f"VQA fine-tune @{spec.image_size} ({n} questions)"
    base = seeded_params(spec, dev)
    against_plain(label, cfg, spec, base, batch, dev)
    launches += train_in_turns(
        label, objective_runs(CONFIG_VQA, spec, base, TRAIN_STEPS, **over),
        batch, n, {"kernels": fused_pass_launches(spec, n)}, card,
        unit="questions")
    del base

    n = IMAGENET_BATCH
    over = dict(per_device_batch_size=n, batch_size=n)
    cfg = build_config(*CONFIG_IMAGENET, overrides=over)
    spec = make_model_spec(cfg)
    batch = {"image": torch.randn(n, 3, spec.image_size, spec.image_size,
                                  device=dev, generator=gen),
             "class_label": torch.randint(0, spec.img_cls_label_size, (n,),
                                          device=dev, generator=gen)}
    base = seeded_params(spec, dev)
    label = f"ImageNet fine-tune @{spec.image_size} ({n} images)"
    against_plain(f"{label}, adamw", cfg, spec, base, batch, dev)
    runs = {}
    for optim in ("adamw", "adam", "sgd"):
        r = objective_runs(CONFIG_IMAGENET, spec, base, TRAIN_STEPS,
                           plain=optim == "adamw", optim_type=optim, **over)
        runs[optim] = r.pop("kernels")
        runs.update({f"plain {optim}": v for v in r.values()})
    want = tower_launches(spec, spec.image_len, n)
    launches += train_in_turns(
        label, runs, batch, n, dict.fromkeys(("adamw", "adam", "sgd"), want),
        card, unit="images")
    return dict(launches)


def run_objectives(dev, card: str) -> dict:
    """Phase 13: (a)-(d); the launches of every kernel-path step."""
    counts = [run_nlvr2_train(dev, card), run_pretrain(dev, card),
              run_all_in_one(dev, card), run_finetunes(dev, card)]
    return {k: sum(c.get(k, 0) for c in counts) for k in KERNELS}


# --------------------------------------------------------------------------
# Phase 14: the Trainer, the CLIs and the data pipeline
# --------------------------------------------------------------------------

# COCO-style arrows at ARROW_PX, written here: train, val and test each of
# ARROW_IMAGES random-noise JPEGs with ARROW_CAPTIONS captions of 3 to 12
# words from CAPTION_WORDS (the vocabulary the phase writes)
ARROW_PX, ARROW_IMAGES, ARROW_CAPTIONS = 384, 32, 5
CAPTION_WORDS = ("a", "an", "the", "dog", "cat", "man", "woman", "child",
                 "plays", "sits", "runs", "eats", "holds", "with", "on",
                 "in", "near", "under", "red", "blue", "green", "small",
                 "large", "ball", "table", "street", "field", "water",
                 "bench", "kite", "bus", "train", "plate", "pizza", "horse",
                 "bird", "tree", "road", "snow", "beach")
# the Trainer: 2 micro-batches of 16 a step (_stack_micro), a validation
# after step 2 (val_check_interval in loader batches) and one at the end
TRAINER_MICRO, TRAINER_STEPS, TRAINER_VCI = 16, 3, 4
# the gram CLI's batches (limit_val_batches over the val loader's 10)
GRAM_CLI_BATCHES = 2


def write_coco_arrows(root: Path, train_sizes=None) -> str:
    """The vocabulary and the three COCO karpathy arrows under ``root``, in
    the reference writers' schema (image bytes, caption list, image_id,
    split); returns the vocabulary's path.  The JPEGs are ARROW_PX square,
    or in the train split the (h, w) of ``train_sizes`` in turn."""
    import io

    import pyarrow as pa
    from PIL import Image

    from vl_merging_tpu_torch.data import write_tiny_vocab

    vocab = write_tiny_vocab(str(root / "vocab.txt"), list(CAPTION_WORDS))
    for k, split in enumerate(("train", "val", "test")):
        rng = np.random.RandomState(SEED + 60 + k)
        images, captions = [], []
        for i in range(ARROW_IMAGES):
            h, w = (train_sizes[i % len(train_sizes)]
                    if split == "train" and train_sizes else
                    (ARROW_PX, ARROW_PX))
            pixels = (rng.rand(h, w, 3) * 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(pixels).save(buf, format="JPEG")
            images.append(buf.getvalue())
            captions.append([" ".join(rng.choice(CAPTION_WORDS,
                                                 rng.randint(3, 13)))
                             for _ in range(ARROW_CAPTIONS)])
        table = pa.Table.from_arrays(
            [pa.array(images), pa.array(captions),
             pa.array([f"{split}_{i:012d}.jpg" for i in range(ARROW_IMAGES)]),
             pa.array([split] * ARROW_IMAGES)],
            names=["image", "caption", "image_id", "split"])
        with pa.OSFile(str(root / f"coco_caption_karpathy_{split}.arrow"),
                       "wb") as sink:
            with pa.RecordBatchFileWriter(sink, table.schema) as w:
                w.write_table(table)
    return vocab



def trainer_overrides(root: Path, vocab: str, log_dir, **over) -> dict:
    """The phase's config: the COCO irtr @384 config with the phase's data,
    2 micro-batches of TRAINER_MICRO a step, no warm-up.  The Trainer runs
    (fit, resume, uninterrupted) train on the eval transform
    (``square_transform``): the host's augmentation draws are no part of a
    resumed run's state, and with them the resumed and uninterrupted runs
    would see other pixels; ``run.main`` keeps the config's RandAugment."""
    o = dict(data_root=str(root), tokenizer=vocab, log_dir=str(log_dir),
             per_device_batch_size=TRAINER_MICRO,
             batch_size=2 * TRAINER_MICRO, max_steps=TRAINER_STEPS,
             val_check_interval=TRAINER_VCI, warmup_steps=0,
             train_transform_keys=["square_transform"])
    o.update(over)
    return o


def argv_of(names, over: dict) -> list:
    return list(names) + [f"{k}={v!r}" for k, v in over.items()]


class RecordingTrainer(Trainer):
    """A Trainer that keeps each optimizer step's metrics, as floats."""

    def _build_step(self, max_steps: int):
        super()._build_step(max_steps)
        step_fn, self.steps = self.step_fn, {}

        def step(state, feed):
            state, metrics = step_fn(state, feed)
            self.steps[state.step] = {k: float(v)
                                      for k, v in metrics.items()}
            return state, metrics

        self.step_fn = step


def trainer_launches(spec, steps: int, validations: int,
                     val_batches: int, with_recall: bool,
                     micro: int = TRAINER_MICRO,
                     accum: int = 2) -> collections.Counter:
    """A fit's launches: per micro-batch both towers' training blocks (K2,
    K9 at 577 tokens, K13 in every block); per validation the eval step
    over the val loader's batches (both towers, "tail": K1-K3 and K13) and,
    with the recall, both splits' recall (one text batch of every caption,
    one image batch)."""
    L, T = spec.num_layers, spec.max_text_len
    train = block_launches(N, micro, L) + block_launches(T, micro, L)
    eval_step = (block_launches(N, micro, L, fusion="tail", train=False)
                 + block_launches(T, micro, L, fusion="tail", train=False))
    out = scaled(train, steps * accum) + scaled(eval_step,
                                                val_batches * validations)
    if with_recall:
        out += scaled(recall_launches(spec), 2 * validations)
    return out


def recall_launches(spec) -> collections.Counter:
    """``Trainer.recall`` over one split: every caption in one text batch,
    the ARROW_IMAGES images in one image batch."""
    T = spec.max_text_len
    return (tower_launches(spec, N, ARROW_IMAGES, fusion="tail", train=False)
            + tower_launches(spec, T, ARROW_IMAGES * ARROW_CAPTIONS,
                             fusion="tail", train=False))


def run_trainer(dev, card: str) -> dict:
    """Phase 14: ``Trainer.fit`` / ``validate`` / ``recall`` with
    checkpoints and resume, ``run.main`` and ``cache_gram_matrices.main``
    over arrows written here, at full width and depth."""
    from vl_merging_tpu_torch import cache_gram_matrices as gram_cli
    from vl_merging_tpu_torch import run, runtime
    from vl_merging_tpu_torch.data.datamodule import MTDataModule
    from vl_merging_tpu_torch.train.loop import device_feed

    counts = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        vocab = write_coco_arrows(tmp)
        print(f"arrows written: {3 * ARROW_IMAGES} images at "
              f"{ARROW_PX} px, {ARROW_CAPTIONS} captions each "
              f"({time.perf_counter() - t0:.1f} s); native JPEG decode "
              f"{'built' if runtime.available() else 'not built: PIL'}")

        # (1) a 3-step fit, validations after step 2 and at the end
        cfg = build_config(*CONFIG, overrides=trainer_overrides(
            tmp, vocab, tmp / "fit"))
        spec = make_model_spec(cfg)
        t0 = time.perf_counter()
        trainer = RecordingTrainer(cfg)
        print(f"Trainer built in {time.perf_counter() - t0:.1f} s "
              f"(seeded weights, f32 masters on {trainer.device})")
        dm = MTDataModule(cfg)
        val_batches = len(dm.val_loader(TRAINER_MICRO))
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(dm)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts += check_launches(
            f"Trainer.fit ({TRAINER_STEPS} steps of 2 x {TRAINER_MICRO}, 2 "
            f"validations with recall)",
            trainer_launches(spec, TRAINER_STEPS, 2, val_batches, True))
        wait = trainer.host_wait
        if wait["steps"] != TRAINER_STEPS or sorted(trainer.steps) != \
                list(range(1, TRAINER_STEPS + 1)):
            fail(f"Trainer.fit took steps {sorted(trainer.steps)}")
        bad = {s: m for s, m in trainer.steps.items()
               if not all(np.isfinite(v) for v in m.values())}
        if bad:
            fail(f"Trainer.fit: a metric not finite: {bad}")
        print(f"Trainer.fit: {fit_s:.2f} s for {TRAINER_STEPS} steps and 2 "
              f"validations; host wait per step on the loader "
              f"{1e3 * wait['loader_s'] / wait['steps']:.1f} ms, on "
              f"device_feed {1e3 * wait['feed_s'] / wait['steps']:.1f} ms; "
              f"peak memory {peak:.2f} GiB; losses "
              + ", ".join(f"{s}: {m['total_loss']:.6f}"
                          for s, m in sorted(trainer.steps.items()))
              + f" [{card}]")
        lines = [json.loads(line) for line in open(trainer.logger.path)]
        if [r["step"] for r in lines] != [2, TRAINER_STEPS] or not all(
                "val/the_metric" in r and "recalls/test_avg" in r
                for r in lines):
            fail(f"Trainer.fit logged {lines}")
        print("validation metrics: " + json.dumps(lines[-1]))

        # the checkpoints: last and best, weights.ckpt bit for bit
        ck = Path(trainer.log_dir) / "checkpoints"
        for f in ("last/weights.ckpt", "last/meta.json", "last/state.pt",
                  "best/weights.ckpt"):
            if not (ck / f).exists():
                fail(f"Trainer.fit wrote no {f}")
        sd = load_torch_checkpoint(str(ck / "last" / "weights.ckpt"))
        want = params_to_state_dict(trainer.params)
        if set(sd) != set(want) or not all(bit_equal(sd[k], want[k])
                                           for k in want):
            fail("last/weights.ckpt differs from the trainer's params")
        print(f"checkpoints: last (weights.ckpt, meta.json, state.pt) and "
              f"best; last/weights.ckpt read back bit for bit ({len(sd)} "
              f"tensors, step "
              f"{json.load(open(ck / 'last' / 'meta.json'))['step']})")
        del sd, want

        # validate and recall alone, timed
        for what, fn, want in (
                ("Trainer.validate", lambda: trainer.validate(dm),
                 trainer_launches(spec, 0, 1, val_batches, True)),
                ("Trainer.recall (test split)", lambda: trainer.recall(dm),
                 recall_launches(spec))):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts += check_launches(what, want)
            print(f"{what}: {wall:.3f} s [{card}]: " + json.dumps(out))
        del trainer

        # (2) resumed from "last" for step 4; (3) 4 steps uninterrupted
        runs = {}
        for name, log_dir, over in (
                ("resumed", tmp / "fit", dict(resume_during_pretraining=True)),
                ("uninterrupted", tmp / "whole", {})):
            cfg4 = build_config(*CONFIG, overrides=trainer_overrides(
                tmp, vocab, log_dir, max_steps=TRAINER_STEPS + 1,
                get_recall_metric=False, **over))
            t = RecordingTrainer(cfg4)
            reset_launches()
            t.fit(dm)
            steps = TRAINER_STEPS + 1 if name == "uninterrupted" else 1
            validations = 2 if name == "uninterrupted" else 1
            counts += check_launches(
                f"Trainer.fit, {name} ({steps} step(s))",
                trainer_launches(spec, steps, validations, val_batches,
                                 False))
            runs[name] = t
        got, want = runs["resumed"], runs["uninterrupted"]
        step = TRAINER_STEPS + 1
        if sorted(got.steps) != [step] or got.state.step != step:
            fail(f"the resumed fit took steps {sorted(got.steps)}")
        losses = {k: v for k, v in got.steps[step].items()
                  if k.endswith("_loss")}
        rel = max(abs(v - want.steps[step][k]) / abs(want.steps[step][k])
                  for k, v in losses.items())
        cos = global_cosine({k: v.detach() for k, v in got.params.items()},
                            want.params)
        same = all(torch.equal(got.params[k], want.params[k])
                   for k in got.params)
        print(f"resume: step {step} resumed from last (step "
              f"{TRAINER_STEPS}) against an uninterrupted fit: losses "
              f"{losses} vs "
              f"{ {k: want.steps[step][k] for k in losses} }, worst relative "
              f"difference {rel:.2e} (need <= {LOSS_REL}); params global "
              f"cosine {cos:.9f} (need >= {MIN_COSINE}); "
              + ("bit-equal" if same else "not bit-equal: the first fit's "
                 "learning rate decays over its 3 steps, the uninterrupted "
                 "one's over 4"))
        if rel > LOSS_REL or cos < MIN_COSINE:
            fail("the resumed fit disagrees with the uninterrupted one")

        # the step alone, timed as phases 6, 8 and 13 time theirs
        t = runs.pop("uninterrupted")
        del runs, got, want
        loader = dm.train_loader(TRAINER_MICRO)
        it = iter(loader)
        feed = t._stack_micro([next(it), next(it)])
        del it, loader
        L, T = spec.num_layers, spec.max_text_len
        counts += collections.Counter(train_in_turns(
            f"Trainer step (irtr @384, 2 x {TRAINER_MICRO} pairs from the "
            f"arrows)", {"trainer": (t.state, t.step_fn)}, feed,
            2 * TRAINER_MICRO, {"trainer": scaled(
                block_launches(N, TRAINER_MICRO, L)
                + block_launches(T, TRAINER_MICRO, L), 2)}, card))
        del t, feed
        torch.cuda.empty_cache()

        # run.main: a fit on the config's own RandAugment, validation_only
        for label, over, want in (
                ("run.main fit (RandAugment)", dict(
                    max_steps=2, val_check_interval=1.0,
                    train_transform_keys=["square_transform_randaug"]),
                 trainer_launches(spec, 2, 1, val_batches, True)),
                ("run.main validation_only", dict(validation_only=True),
                 trainer_launches(spec, 0, 1, val_batches, True))):
            args = argv_of(CONFIG, trainer_overrides(
                tmp, vocab, tmp / "cli", **over))
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):  # the config dump
                t = run.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts += check_launches(label, want)
            wait = t.host_wait
            per = (f"; host wait per step on the loader "
                   f"{1e3 * wait['loader_s'] / wait['steps']:.1f} ms, on "
                   f"device_feed {1e3 * wait['feed_s'] / wait['steps']:.1f}"
                   f" ms" if wait["steps"] else "")
            print(f"{label}: {wall:.2f} s, the Trainer's build included"
                  f"{per} [{card}]")
            del t
        torch.cuda.empty_cache()

        # the gram CLI on all_moe, held against phase 11's gram pass over
        # the same batches and params
        gram_over = trainer_overrides(
            tmp, vocab, tmp / "grams", representation_name="G",
            gram_precision="f32_device",
            limit_val_batches=GRAM_CLI_BATCHES / val_batches)
        mcfg = build_config(*CONFIG_MOE, overrides=gram_over)
        mspec = make_model_spec(mcfg)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            path = gram_cli.main(argv_of(CONFIG_MOE, gram_over))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gram_k2 = mspec.num_layers * GRAM_CLI_BATCHES
        counts += check_launches(
            "cache_gram_matrices.main", collections.Counter({
                "packed_attention": gram_k2,
                ("packed_attention", N): gram_k2}))
        got = load_torch_checkpoint(path)
        params = params_from_numpy(load_params(mcfg, mspec)[0], dev)
        batches = [device_feed(b, dev) for _, b in zip(
            range(GRAM_CLI_BATCHES), MTDataModule(mcfg).val_loader(
                TRAINER_MICRO))]
        want, _, n = run_gram_pass(params, mspec, mcfg, batches,
                                   "f32_device", "phase 11's, same batches")
        counts += collections.Counter(n)
        if set(got) != set(want):
            fail(f"gram CLI keys {sorted(set(got) ^ set(want))} differ")
        pairs = GRAM_CLI_BATCHES * TRAINER_MICRO
        worst, equal = 0.0, 0
        for k, g in want.items():
            limit = gram_rows(mspec, k, pairs) * F32_EPS * np.abs(g).max()
            err = float(np.abs(got[k] - g).max())
            worst = max(worst, err / limit)
            equal += bit_equal(got[k], g)
            if err > limit:
                fail(f"gram CLI {k}: {err} from phase 11's pass, over "
                     f"rows·2^-24·max|g| = {limit}")
        print(f"cache_gram_matrices.main (all_moe, {GRAM_CLI_BATCHES} "
              f"batches of {TRAINER_MICRO}, f32_device): {wall:.2f} s, the "
              f"params' build included; {len(got)} grams, {equal} bit-equal "
              f"to phase 11's pass on the same batches, the rest within "
              f"{worst:.3f} of rows·2^-24·max|g| [{card}]")
        del params, batches
    return {k: counts[k] for k in KERNELS}


# --------------------------------------------------------------------------
# Phase 15: distribution
# --------------------------------------------------------------------------

# phase 14's step over a global batch of DIST_WORLD x DIST_MICRO pairs: at
# world 1 two micro-batches of DIST_MICRO, at world 2 one a rank; the two
# ranks share the one card through gloo (NCCL refuses two ranks on one
# device)
DIST_WORLD, DIST_MICRO = 2, TRAINER_MICRO
# the Trainer over the ranks: a fit of DIST_FIT_STEPS steps, resumed from
# its checkpoint for one more
DIST_FIT_STEPS = 2


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_config(**over):
    """Phase 14's step: the COCO irtr @384 config, DIST_MICRO pairs a
    device, a global batch of DIST_WORLD x DIST_MICRO, no warm-up."""
    return build_config(*CONFIG, overrides=dict(
        per_device_batch_size=DIST_MICRO, batch_size=DIST_WORLD * DIST_MICRO,
        warmup_steps=0, **over))


def dist_batch(spec, dev) -> dict:
    """The phase's DIST_WORLD x DIST_MICRO pairs, from a seed (every rank
    draws them all and keeps its rows)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    return {k: v[0] for k, v in synthetic_train_batch(
        spec, 1, dev, gen, micro=DIST_WORLD * DIST_MICRO).items()}


def step_launches(spec, micro: int, micro_batches: int):
    L = spec.num_layers
    return scaled(block_launches(N, micro, L)
                  + block_launches(spec.max_text_len, micro, L),
                  micro_batches)


def timed_steps(label: str, state, step, batch, dev, card: str):
    """A warm-up step, TIMED_STEPS timed steps and one step inside
    ``collective_time``: every loss and the grad norm finite; prints the
    best step ms and the collective share.  Returns (state, the params
    after the warm-up step, best ms, collective ms)."""
    times, after_first = [], None
    for i in range(TRAIN_STEPS + 1):
        if i < TRAIN_STEPS:
            state, metrics, ms = timed_step(step, state, batch)
        else:
            with collective_time(dev) as spent:
                state, metrics, ms = timed_step(step, state, batch)
        if i == 0:
            after_first = {k: v.detach().clone()
                           for k, v in state.full_params().items()}
        elif i < TRAIN_STEPS:
            times.append(ms)
        losses = {k: float(v) for k, v in metrics.items()
                  if k.endswith("_loss") or k == "grad_norm"}
        if not all(np.isfinite(v) for v in losses.values()):
            fail(f"{label}: a loss or the grad norm not finite: {losses}")
    best = min(times)
    print(f"{label}: {best:.1f} ms a step (best of {TIMED_STEPS} after a "
          f"warm-up step); a step with its collectives timed: {ms:.1f} ms, "
          f"{spent['ms']:.1f} ms in {spent['calls']} collectives "
          f"({spent['ms'] / ms:.1%}) [{card}]")
    return state, after_first, best, spent["ms"]


def distribution_rank(rank: int, store: str, tmp: str) -> None:
    """One rank of phase 15 (b), on cuda:0 in a gloo group of DIST_WORLD
    (``torch.multiprocessing``): the step's gradients, the data-parallel
    step timed, the sharded step, and the Trainer (fit, validate, recall,
    a checkpoint written by rank 0 and resumed on every rank).  Saves its
    results and launches to ``{tmp}/rank{rank}.pt``."""
    from vl_merging_tpu_torch import parallel
    from vl_merging_tpu_torch.ckpt import io as ckpt_io
    from vl_merging_tpu_torch.data.datamodule import MTDataModule
    from vl_merging_tpu_torch.device import rank_device
    from vl_merging_tpu_torch.parallel import host
    from vl_merging_tpu_torch.parallel.mesh import average_grads, make_mesh

    dev = rank_device("cuda:0")
    parallel.initialize("gloo", init_method=f"file://{store}",
                        world_size=DIST_WORLD, rank=rank)
    _build.library()          # built by the parent: loaded, not built
    card = card_line()
    tag = f"rank {rank}/{DIST_WORLD} (gloo, cuda:0)"
    cfg = dist_config()
    spec = make_model_spec(cfg)
    base = seeded_params(spec, dev)
    batch = {k: v[host.process_rows(DIST_WORLD * DIST_MICRO)]
             for k, v in dist_batch(spec, dev).items()}
    out, counts = {}, collections.Counter()

    # (1) the step's loss and averaged gradients, for the parent to hold
    reset_launches()
    gen = torch.Generator(device=dev).manual_seed(SEED + 71)
    _, metrics, grads = train_step.loss_and_grads(
        master_params(base), spec, cfg, batch, gen, kernels=True,
        dp_scale=1 / DIST_WORLD)
    average_grads(grads, make_mesh())
    metrics = train_step.reduce_metrics(metrics)
    counts += check_launches(f"{tag}: the step's gradients",
                             step_launches(spec, DIST_MICRO, 1))
    if rank == 0:
        torch.save({"grads": {k: v.cpu() for k, v in grads.items()},
                    "losses": {k: float(v) for k, v in metrics.items()
                               if k.endswith("_loss")}},
                   f"{tmp}/grads.pt")
    del grads

    # (2) the data-parallel step; (3) the sharded step from the same params
    reset_launches()
    state, step = build_train_step(cfg, spec, master_params(base),
                                   TRAIN_STEPS + 1)
    if (step_accum := accum_steps(cfg)) != 1:
        fail(f"{tag}: {step_accum} micro-batches a step, want 1")
    state, dp_first, out["step_ms"], out["collective_ms"] = timed_steps(
        f"{tag}: the data-parallel step ({DIST_MICRO} pairs a rank, a "
        f"global batch of {DIST_WORLD * DIST_MICRO})", state, step, batch,
        dev, card)
    counts += check_launches(f"{tag}: the data-parallel step",
                             step_launches(spec, DIST_MICRO,
                                           TRAIN_STEPS + 1))
    del state, step
    reset_launches()
    state, step = build_train_step(dist_config(use_sharded_training=True),
                                   spec, master_params(base), TRAIN_STEPS + 1)
    sharded = [k for k, v in state.params.items() if v.shape != base[k].shape]
    if (state.mesh.data, state.mesh.fsdp) != (1, DIST_WORLD) or not sharded:
        fail(f"{tag}: the sharded state is not sharded")
    # the state holds its shards (params and both moments) in storage of
    # their own: nothing keeps the full f32 masters alive
    trees = (state.params, state.opt_state.mu, state.opt_state.nu)
    held = storage_bytes(trees)
    shards = sum(v.numel() * v.element_size() for t in trees
                 for v in t.values())
    full = 3 * sum(v.numel() * 4 for v in base.values())
    print(f"{tag}: the sharded state holds {held / 2**20:.1f} MiB of "
          f"params and moments, {held / full:.3f} of the full f32 state's "
          f"{full / 2**20:.1f} MiB")
    if held != shards:
        fail(f"{tag}: the sharded state holds {held} bytes, its shards "
             f"{shards}: a shard keeps a full tensor alive")
    state, sh_first, out["sharded_step_ms"], out["sharded_collective_ms"] = \
        timed_steps(f"{tag}: the sharded step ({len(sharded)} of "
                    f"{len(base)} params in halves)", state, step, batch,
                    dev, card)
    counts += check_launches(f"{tag}: the sharded step",
                             step_launches(spec, DIST_MICRO,
                                           TRAIN_STEPS + 1))
    cos = global_cosine({k: sh_first[k] - base[k] for k in base},
                        {k: dp_first[k] - base[k] for k in base})
    print(f"{tag}: the sharded step's update against the data-parallel "
          f"step's: global cosine {cos:.6f} (need >= {MIN_COSINE})")
    if cos < MIN_COSINE:
        fail(f"{tag}: the sharded step disagrees with the data-parallel one")
    del state, step, dp_first, sh_first
    torch.cuda.empty_cache()

    # (4) the Trainer over the ranks: fit, validate, recall; the checkpoint
    root = Path(tmp)
    vocab = str(root / "vocab.txt")
    writes = []
    save_ckpt, save = ckpt_io.save_torch_checkpoint, torch.save

    def record_ckpt(sd, path):
        writes.append(Path(path).name)
        return save_ckpt(sd, path)

    def record_save(obj, path, *args, **kwargs):
        writes.append(Path(str(path)).name)
        return save(obj, path, *args, **kwargs)

    tcfg = build_config(*CONFIG, overrides=trainer_overrides(
        root, vocab, root / "fit", max_steps=DIST_FIT_STEPS,
        num_devices=DIST_WORLD))
    dm = MTDataModule(tcfg)
    val_batches = len(dm.val_loader(TRAINER_MICRO))
    trainer = RecordingTrainer(tcfg, device="cuda:0")
    ckpt_io.save_torch_checkpoint, torch.save = record_ckpt, record_save
    reset_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(dm)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        ckpt_io.save_torch_checkpoint, torch.save = save_ckpt, save
    counts += check_launches(
        f"{tag}: Trainer.fit ({DIST_FIT_STEPS} steps, 1 validation with "
        f"recall over {val_batches} val batches a rank)",
        trainer_launches(spec, DIST_FIT_STEPS, 1, val_batches, True,
                         accum=1))
    print(f"{tag}: Trainer.fit {fit_s:.2f} s; losses "
          + ", ".join(f"{s}: {m['total_loss']:.6f}"
                      for s, m in sorted(trainer.steps.items()))
          + f"; files written {sorted(writes)} [{card}]")
    out.update(fit_s=fit_s, writes=writes, steps=trainer.steps,
               log_dir=trainer.log_dir)
    for what, fn, want in (
            ("Trainer.validate", lambda: trainer.validate(dm),
             trainer_launches(spec, 0, 1, val_batches, True)),
            ("Trainer.recall (test split)", lambda: trainer.recall(dm),
             recall_launches(spec))):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        out[what] = (got, time.perf_counter() - t0)
        counts += check_launches(f"{tag}: {what}", want)
    if rank == 0:   # the recalled params: the resume below moves "last" on
        shutil.copy(Path(trainer.log_dir) / "checkpoints" / "last" /
                    "weights.ckpt", root / "recalled.ckpt")
    trainer.logger.close()
    del trainer
    torch.cuda.empty_cache()
    rcfg = build_config(*CONFIG, overrides=trainer_overrides(
        root, vocab, root / "fit", max_steps=DIST_FIT_STEPS + 1,
        num_devices=DIST_WORLD, get_recall_metric=False,
        resume_during_pretraining=True))
    resumed = RecordingTrainer(rcfg, device="cuda:0")
    reset_launches()
    resumed.fit(dm)
    counts += check_launches(
        f"{tag}: Trainer.fit resumed from step {DIST_FIT_STEPS}",
        trainer_launches(spec, 1, 1, val_batches, False, accum=1))
    if sorted(resumed.steps) != [DIST_FIT_STEPS + 1]:
        fail(f"{tag}: the resumed fit took steps {sorted(resumed.steps)}")
    out["resumed"] = resumed.steps
    resumed.logger.close()
    out["counts"] = {k: counts[k] for k in KERNELS}
    torch.save(out, f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


def one_process_recall(cfg, spec, dev, root: Path, weights: Path,
                       shares: int) -> dict:
    """``Trainer.recall``'s R@k at world ``shares`` computed in this one
    process (no group) from the params of ``weights`` (read as they are,
    no surgery): the towers over the split's batches of the world's size,
    each cut into its ``shares`` row shares fed as batches of their own,
    then ``compute_irtr_recall``."""
    from vl_merging_tpu_torch.ckpt.io import state_dict_to_params
    from vl_merging_tpu_torch.data.datamodule import MTDataModule
    from vl_merging_tpu_torch.train.loop import device_feed, pad_to_multiple

    tcfg = build_config(*CONFIG, overrides=trainer_overrides(
        root, str(root / "vocab.txt"), root / "one"))
    params, _, _ = state_dict_to_params(
        load_torch_checkpoint(str(weights)), spec)
    params = eval_cast_params({k: v.to(dev) for k, v in params.items()},
                              spec, cfg)
    dm = MTDataModule(tcfg).dms[0]
    text_dset = dm.make_no_false_test_dset()
    image_dset = dm.make_no_false_test_dset(image_only=True)

    def collect(dset):
        bs = min(max(256 // DIST_WORLD * DIST_WORLD, DIST_WORLD),
                 -(-len(dset) // DIST_WORLD) * DIST_WORLD)
        batches, ids = [], []
        for start in range(0, len(dset), bs):
            idx = range(start, min(start + bs, len(dset)))
            b = dset.collate([dset[i] for i in idx], dm.mlm_collator)
            ids += list(b["img_index"])
            feed = device_feed(pad_to_multiple(b, bs)[0], dev)
            batches += [{k: v.chunk(shares)[r] for k, v in feed.items()}
                        for r in range(shares)]
        return batches, ids

    text_batches, tiids = collect(text_dset)
    image_batches, iids = collect(image_dset)
    return compute_irtr_recall(params, spec, text_batches, image_batches,
                               np.asarray(tiids), np.asarray(iids))


def run_distribution(dev, card: str) -> dict:
    """Phase 15: (a) phase 14's step at world 1 under NCCL against the
    same step without a process group (bit-equal); (b) two ranks on the
    one card under gloo (``distribution_rank``): their step's losses and
    gradients against one process's over the global batch at dp_scale
    1/2, the data-parallel and sharded steps timed with their collective
    share, the Trainer over the ranks (its recall against one process's
    on the checkpoint it wrote, ``one_process_recall``)."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from vl_merging_tpu_torch import parallel

    cfg = dist_config()
    spec = make_model_spec(cfg)
    base = seeded_params(spec, dev)
    batch = dist_batch(spec, dev)
    counts = collections.Counter()

    # (a) world 1 under NCCL, bit-equal to no group
    accum = accum_steps(cfg)
    feed = {k: v.reshape(accum, DIST_MICRO, *v.shape[1:])
            for k, v in batch.items()}
    runs = {}
    for name in ("no group", "world 1 (NCCL)"):
        if name != "no group":
            parallel.initialize("nccl", init_method=f"tcp://localhost:"
                                f"{free_port()}", world_size=1, rank=0)
            probe = torch.ones(4, device=dev)
            dist.all_reduce(probe)
            if dist.get_backend() != "nccl" or probe.tolist() != [1.0] * 4:
                fail("the world-1 group is not NCCL's")
        state, step = build_train_step(cfg, spec, master_params(base), 10)
        reset_launches()
        with collective_time(dev) as spent:
            state, metrics, ms = timed_step(step, state, feed)
        if name != "no group":
            counts += check_launches(f"phase 15 (a), {name}: one step",
                                     step_launches(spec, DIST_MICRO, accum))
        runs[name] = (state.params, metrics)
        print(f"phase 15 (a), {name}: one step of {accum} x {DIST_MICRO} "
              f"pairs {ms:.1f} ms, {spent['ms']:.2f} ms in "
              f"{spent['calls']} collective calls [{card}]")
        del state, step
    dist.destroy_process_group()
    (p0, m0), (p1, m1) = runs.values()
    if not (all(torch.equal(p0[k], p1[k]) for k in p0)
            and all(torch.equal(m0[k], m1[k]) for k in m0)):
        fail("phase 15 (a): the world-1 step differs from the step without "
             "a process group")
    print("phase 15 (a): the world-1 NCCL step's params and metrics are "
          "bit-equal to the step's without a process group")
    del runs, p0, p1

    # the one-process reference of (b): the step over the global batch at
    # dp_scale 1/2
    gen = torch.Generator(device=dev).manual_seed(SEED + 71)
    _, want_metrics, want_grads = train_step.loss_and_grads(
        master_params(base), spec, cfg, batch, gen, kernels=True,
        dp_scale=1 / DIST_WORLD)
    want_losses = {k: float(v) for k, v in want_metrics.items()
                   if k.endswith("_loss")}
    del base, batch, feed
    torch.cuda.empty_cache()

    # (b) two ranks on the card
    with tempfile.TemporaryDirectory() as tmp:
        write_coco_arrows(Path(tmp))
        t0 = time.perf_counter()
        mp.start_processes(distribution_rank,
                           args=(f"{tmp}/store", tmp), nprocs=DIST_WORLD,
                           join=True, start_method="spawn")
        wall = time.perf_counter() - t0
        got = torch.load(f"{tmp}/grads.pt", weights_only=True)
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                 for r in range(DIST_WORLD)]
        rel = max(abs(got["losses"][k] - v) / abs(v)
                  for k, v in want_losses.items())
        cos = global_cosine({k: v.to(dev) for k, v in got["grads"].items()},
                            want_grads)
        print(f"phase 15 (b): the world-2 step's losses {got['losses']} "
              f"against one process's over the {DIST_WORLD * DIST_MICRO} "
              f"pairs at dp_scale 1/{DIST_WORLD} {want_losses}: worst "
              f"relative difference {rel:.2e} (need <= {LOSS_REL}); "
              f"averaged gradients global cosine {cos:.6f} (need >= "
              f"{MIN_COSINE}); the two ranks' run {wall:.1f} s, their "
              f"start included")
        if rel > LOSS_REL or cos < MIN_COSINE:
            fail("phase 15 (b): the world-2 step disagrees with one "
                 "process's")
        del got, want_grads
        if ranks[1]["writes"] or "weights.ckpt" not in ranks[0]["writes"] \
                or "state.pt.tmp" not in ranks[0]["writes"]:
            fail(f"phase 15 (b): checkpoint writes by rank "
                 f"{[r['writes'] for r in ranks]}; rank 0 alone writes")
        recall = [r["Trainer.recall (test split)"][0] for r in ranks]
        want_recall = {
            split: one_process_recall(cfg, spec, dev, Path(tmp),
                                      Path(tmp) / "recalled.ckpt",
                                      shares=shares)
            for split, shares in (("shares", DIST_WORLD), ("whole", 1))}
        print(f"phase 15 (b): Trainer.recall at world {DIST_WORLD} "
              f"{recall[0]}; one process on the fit's checkpoint (step "
              f"{DIST_FIT_STEPS}, the recalled params) rank 0 wrote, "
              f"its towers fed the ranks' row shares as batches "
              f"{want_recall['shares']}, fed whole batches "
              f"{want_recall['whole']}")
        if recall[0] != recall[1] or any(recall[0] != v
                                         for v in want_recall.values()):
            fail("phase 15 (b): the world-2 recall differs from one "
                 "process's")
        for r in ranks:
            counts.update(r["counts"])
    print(f"phase 15: step ms a rank at world {DIST_WORLD} (data-parallel) "
          f"{[round(r['step_ms'], 1) for r in ranks]}, collectives "
          f"{[round(r['collective_ms'], 1) for r in ranks]} ms; sharded "
          f"{[round(r['sharded_step_ms'], 1) for r in ranks]}, collectives "
          f"{[round(r['sharded_collective_ms'], 1) for r in ranks]} ms "
          f"[{card}]")
    return {k: counts[k] for k in KERNELS}


# --------------------------------------------------------------------------
# Phase 16: device-side preprocessing
# --------------------------------------------------------------------------

# native (h, w) sizes of COCO-like photos, all within the 640 canvas; the
# last upscales to 384
NATIVE_SIZES = ((480, 640), (640, 427), (375, 500), (500, 333), (640, 640),
                (300, 400))
# the train arrows of (b): the sizes above and one larger than the canvas
# (the dataset downscales it to fit before it rides the link)
TRAIN_SIZES = NATIVE_SIZES + ((720, 540),)
CANVAS_IMAGES = 64
# the resize against PIL (the JAX package's bound, tests/test_jax_image.py)
# and the augment on the card against the port on the CPU
RESIZE_EXACT, RESIZE_MAX, RESIZE_MEAN = 0.997, 2, 0.005
AUGMENT_EQUAL, AUGMENT_MAX = 0.999, 2


def photo_like(rng, h: int, w: int) -> np.ndarray:
    """A smooth (h, w, 3) uint8 image: upscaled noise, which filters like a
    photo (``tests/test_jax_image.py``)."""
    from PIL import Image

    small = (rng.rand(max(2, h // 8), max(2, w // 8), 3) * 255).astype(
        np.uint8)
    return np.asarray(Image.fromarray(small).resize((w, h), Image.BILINEAR))


def byte_agreement(label: str, got: np.ndarray, want: np.ndarray,
                   share: float, worst: int, mean: float = None) -> float:
    """The share of equal bytes, the largest and mean |Δ|, against the
    bounds; returns the share."""
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    eq, mx, mn = float((d == 0).mean()), int(d.max()), float(d.mean())
    print(f"{label}: {eq:.6f} of {d.size} bytes equal ({int((d != 0).sum())}"
          f" differ), max |Δ| {mx}, mean |Δ| {mn:.2e} (need >= {share}, "
          f"<= {worst}" + (f", < {mean}" if mean is not None else "") + ")")
    if eq < share or mx > worst or (mean is not None and mn >= mean):
        fail(f"{label}: outside the bounds")
    return eq


def run_canvas_eval(dev, card: str) -> collections.Counter:
    """(a) bench.py's end-to-end eval image path: native-size uint8 images
    on one canvas, to the card as uint8, ``resize_normalize_nchw`` there,
    then the image tower by "tail"; against the host path (PIL resize,
    normalized f32 to the card, the same tower) in turns."""
    from PIL import Image

    from vl_merging_tpu_torch.ops import image as image_ops

    cfg = build_config(*CONFIG)
    spec = make_model_spec(cfg)
    S = spec.image_size
    rng = np.random.RandomState(SEED + 70)
    natives = [photo_like(rng, *NATIVE_SIZES[i % len(NATIVE_SIZES)])
               for i in range(CANVAS_IMAGES)]
    canvas, sizes = image_ops.pack_canvas(natives)
    t0 = time.perf_counter()
    pil = np.stack([np.asarray(Image.fromarray(im).resize((S, S),
                                                          Image.BICUBIC))
                    for im in natives])
    host_resize_s = time.perf_counter() - t0
    resized = np.ascontiguousarray(np.transpose(
        (pil.astype(np.float32) / np.float32(255) - np.float32(0.5))
        / np.float32(0.5), (0, 3, 1, 2)))

    canvas_d = torch.from_numpy(canvas).to(dev)
    sizes_d = torch.from_numpy(sizes).to(dev)
    got = image_ops.pil_resize_bicubic_u8(canvas_d, sizes_d, S).cpu().numpy()
    byte_agreement(f"phase 16 (a): resize of {CANVAS_IMAGES} images at "
                   f"{sorted(set(NATIVE_SIZES))} on a {canvas.shape[1]}x"
                   f"{canvas.shape[2]} canvas to {S} on the card vs PIL",
                   got, pil, RESIZE_EXACT, RESIZE_MAX, RESIZE_MEAN)
    resize_ms = time_ms(lambda: image_ops.resize_normalize_nchw(
        canvas_d, sizes_d, S))
    mib = canvas.nbytes / 2**20
    print(f"phase 16 (a): resize_normalize_nchw {resize_ms:.3f} ms for "
          f"{CANVAS_IMAGES} images on the card (uint8 {mib:.1f} MiB in); PIL "
          f"on the host {1e3 * host_resize_s:.1f} ms [{card}]")
    del canvas_d, sizes_d

    params = eval_cast_params(seeded_params(spec, dev), spec, cfg)

    def canvas_path():
        feats = []
        for i in range(0, CANVAS_IMAGES, IMAGE_BATCH):
            c = torch.from_numpy(canvas[i:i + IMAGE_BATCH]).to(dev)
            hw = torch.from_numpy(sizes[i:i + IMAGE_BATCH]).to(dev)
            feats.append(extract_features(params, spec, [{
                "image": image_ops.resize_normalize_nchw(c, hw, S)}],
                "image", fusion="tail"))
        return torch.cat(feats)

    def host_path():
        return extract_features(params, spec, [
            {"image": torch.from_numpy(resized[i:i + IMAGE_BATCH]).to(dev)}
            for i in range(0, CANVAS_IMAGES, IMAGE_BATCH)], "image",
            fusion="tail")

    with torch.no_grad():
        reset_launches()
        feats = canvas_path()
        counts = check_launches(
            f"phase 16 (a): canvas eval, {CANVAS_IMAGES} images",
            scaled(tower_launches(spec, N, IMAGE_BATCH, fusion="tail",
                                  train=False), CANVAS_IMAGES // IMAGE_BATCH))
        want = host_path()
        same = torch.equal(feats, want)
        cos = float(F.cosine_similarity(feats.float(), want.float(),
                                        dim=-1).min())
        print(f"phase 16 (a): cls_feats of the canvas path vs the host "
              f"path: min cosine {cos:.6f} (need >= {MIN_COSINE}); "
              + ("bit-equal" if same else "not bit-equal"))
        if cos < MIN_COSINE or not bool(torch.isfinite(feats).all()):
            fail("phase 16 (a): the canvas path disagrees with the host path")
        rates = {"canvas": [], "host": []}
        for which in ("host", "canvas", "canvas", "host"):
            rates[which].append(per_sec(
                canvas_path if which == "canvas" else host_path,
                CANVAS_IMAGES))
    print(f"phase 16 (a): end to end from host arrays, uint8 canvas + "
          f"device resize {max(rates['canvas']):.1f} img/s, PIL-resized f32 "
          f"{max(rates['host']):.1f} img/s (best of 2 in turns; the host "
          f"path's PIL resize not included) [{card}]")
    return collections.Counter(counts)


def augment_gate(cfg, batch, dev, card: str) -> None:
    """``augment_bytes`` of one loaded micro-batch on the card against the
    port on the CPU, its host draws attached."""
    from vl_merging_tpu_torch.ops import augment

    host = train_step.attach_augment_params(
        dict(batch), cfg, np.random.RandomState(SEED + 71))
    params = {k[4:]: torch.from_numpy(v) for k, v in host.items()
              if k.startswith("aug_")}
    canvas = torch.from_numpy(host["image_canvas"])
    S = cfg["image_size"]
    want = augment.augment_bytes(canvas, params, S).numpy()
    got = augment.augment_bytes(canvas.to(dev), {
        k: v.to(dev) for k, v in params.items()}, S).cpu().numpy()
    ops = collections.Counter(augment.OPS[i] for i, a in zip(
        host["aug_op_idx"].ravel(), host["aug_op_apply"].ravel()) if a)
    byte_agreement(f"phase 16 (b): augment_train_batch of one micro-batch "
                   f"({len(canvas)} images, applied ops {dict(ops)}) on the "
                   f"card vs the port on the CPU", got, want, AUGMENT_EQUAL,
                   AUGMENT_MAX)
    canvas, params = canvas.to(dev), {k: v.to(dev)
                                      for k, v in params.items()}
    ms = time_ms(lambda: augment.augment_train_batch(canvas, params, S))
    print(f"phase 16 (b): augment_train_batch {ms:.3f} ms for "
          f"{len(canvas)} images ({canvas.shape[1]} canvas to {S}) [{card}]")


def run_augment_trainer(dev, card: str) -> collections.Counter:
    """(b) ``Trainer.fit`` with ``device_augment`` (2 steps of 2 x 16
    pairs and a validation) over arrows of mixed native sizes, one over
    the canvas, beside the same fit on the host's RandAugment."""
    from vl_merging_tpu_torch.data.datamodule import MTDataModule

    counts = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        vocab = write_coco_arrows(tmp, train_sizes=TRAIN_SIZES)
        waits = {}
        for name, over in (
                ("device_augment", dict(device_augment=True)),
                ("host RandAugment", dict(
                    train_transform_keys=["square_transform_randaug"]))):
            cfg = build_config(*CONFIG, overrides=trainer_overrides(
                tmp, vocab, tmp / name.replace(" ", "_"), max_steps=2,
                val_check_interval=1.0, get_recall_metric=False, **over))
            spec = make_model_spec(cfg)
            trainer = RecordingTrainer(cfg)
            dm = MTDataModule(cfg)
            if name == "device_augment":
                batch = next(iter(dm.train_loader(TRAINER_MICRO)))
                if "image_canvas" not in batch or "image" in batch:
                    fail(f"phase 16 (b): the device_augment loader gave "
                         f"{sorted(batch)}")
                augment_gate(cfg, batch, dev, card)
                del batch
            val_batches = len(dm.val_loader(TRAINER_MICRO))
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.fit(dm)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts += check_launches(
                f"phase 16 (b): Trainer.fit, {name} (2 steps of 2 x "
                f"{TRAINER_MICRO}, a validation)",
                trainer_launches(spec, 2, 1, val_batches, False))
            bad = {s: m for s, m in trainer.steps.items()
                   if not all(np.isfinite(v) for v in m.values())}
            if sorted(trainer.steps) != [1, 2] or bad:
                fail(f"phase 16 (b), {name}: steps {sorted(trainer.steps)},"
                     f" a metric not finite: {bad}")
            w = trainer.host_wait
            waits[name] = (1e3 * w["loader_s"] / w["steps"],
                           1e3 * w["feed_s"] / w["steps"])
            print(f"phase 16 (b): Trainer.fit, {name}: {wall:.2f} s; losses "
                  + ", ".join(f"{s}: {m['total_loss']:.6f}"
                              for s, m in sorted(trainer.steps.items())))
            del trainer
    print("phase 16 (b): host wait per step, " + "; ".join(
        f"{n}: loader {a:.1f} ms, device_feed {b:.1f} ms"
        for n, (a, b) in waits.items())
        + f" (2 steps of 2 x {TRAINER_MICRO} pairs; natives "
        f"{sorted(set(TRAIN_SIZES))}) [{card}]")
    return counts


def word_id_maps(masks: torch.Tensor, rng) -> torch.Tensor:
    """The collator's word-boundary map for captions with ``masks`` (on the
    CPU): -1 on [CLS] (position 0), the last valid token ([SEP]) and
    padding; words of 1 to 3 tokens elsewhere (continuations share their
    word's id)."""
    B, T = masks.shape
    lengths = masks.sum(1).tolist()
    out = np.full((B, T), -1, np.int64)
    for i, n in enumerate(lengths):
        pos, g = 1, 0
        while pos < n - 1:
            ln = min(int(rng.randint(1, 4)), n - 1 - pos)
            out[i, pos:pos + ln] = g
            pos, g = pos + ln, g + 1
    return torch.from_numpy(out)


def mlm_gate(cfg, spec, batch, dev) -> None:
    """The masking core on the card against the CPU on the same draws (bit
    for bit), and the masks' form: labels -100 off the mask, the masked
    tokens on word positions only."""
    from vl_merging_tpu_torch.ops import text_masking

    wid = batch["text_word_ids"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 72)
    draws = text_masking.mlm_draws(wid.shape, gen, spec.vocab_size, True)
    args = (batch["text_ids"], wid < 0)
    got = text_masking.apply_mlm(*args, draws, cfg["mlm_prob"], 103,
                                 word_ids=wid)
    want = text_masking.apply_mlm(
        *(a.cpu() for a in args), {k: v.cpu() for k, v in draws.items()},
        cfg["mlm_prob"], 103, word_ids=wid.cpu())
    same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    ids_mlm, labels = got
    masked = labels != -100
    shapely = (not bool((masked & (wid < 0)).any())
               and torch.equal(labels[masked], batch["text_ids"][masked])
               and torch.equal(ids_mlm[~masked], batch["text_ids"][~masked]))
    print(f"phase 16 (c): whole-word masking core of {tuple(wid.shape)} on "
          f"the card vs the CPU on the same draws: "
          + ("bit-equal" if same else "differs")
          + f"; {int(masked.sum())} of {int((wid >= 0).sum())} word tokens "
          f"masked, none special, labels -100 off the mask: {shapely}")
    if not same or not shapely or not bool(masked.any()):
        fail("phase 16 (c): the device masks are wrong")


# phase 16 (c)'s config: phase 13's pretrain with whole-word masking
DEVICE_PRETRAIN = dict(per_device_batch_size=PRETRAIN_PAIRS,
                       batch_size=PRETRAIN_PAIRS, whole_word_masking=True,
                       mask_token_id=103)


def device_pretrain_inputs(dev):
    """(cfg, spec, batch, generator) of phase 16 (c): phase 13's 32 pairs
    (masked ids, f32 images: the host-made inputs) with the collator's
    word-id maps and uint8 canvases of native-size images, their host
    augment draws attached (the device preprocessing's inputs)."""
    from vl_merging_tpu_torch.ops import augment, image as image_ops

    cfg = build_config(*CONFIG_PRETRAIN, overrides=dict(
        DEVICE_PRETRAIN, pallas_attention=True))
    spec = make_model_spec(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    batch = pretrain_batch(spec, cfg, PRETRAIN_PAIRS, dev, gen)
    rng = np.random.RandomState(SEED + 73)
    batch["text_word_ids"] = word_id_maps(batch["text_masks"].cpu(),
                                          rng).to(dev)
    canvas, sizes = image_ops.pack_canvas(
        [photo_like(rng, *NATIVE_SIZES[i % len(NATIVE_SIZES)])
         for i in range(PRETRAIN_PAIRS)], canvas_hw=(640, 640))
    aug = augment.sample_train_params(rng, sizes, spec.image_size)
    batch["image_canvas"] = torch.from_numpy(canvas).to(dev)
    batch.update({f"aug_{k}": torch.from_numpy(v).to(dev)
                  for k, v in aug.items()})
    return cfg, spec, batch, gen


def device_pretrain_runs(spec, dev, steps: int) -> dict:
    """{"device": (state, step), "host": ...}: the pretrain step with
    ``device_mlm`` and ``device_augment``, and without, from the same
    masters."""
    base = seeded_params(spec, dev)
    return {name: build_train_step(build_config(
        *CONFIG_PRETRAIN, overrides=dict(
            DEVICE_PRETRAIN, warmup_steps=0, pallas_attention=True,
            **flags)), spec, master_params(base), steps)
        for name, flags in (("device", dict(device_mlm=True,
                                            device_augment=True)),
                            ("host", {}))}


def run_device_pretrain(dev, card: str) -> collections.Counter:
    """(c) the VLMo pretrain @224 (all_moe; mlm, ifm, itm; 32 pairs)
    through ``build_train_step`` with ``device_mlm`` (whole-word) and
    ``device_augment`` on uint8 canvases and word-id maps, in turns with
    the same step on host-made inputs (phase 13's: masked ids, f32
    images)."""
    cfg, spec, batch, gen = device_pretrain_inputs(dev)
    mlm_gate(cfg, spec, batch, dev)

    dcfg = dict(cfg, device_mlm=True, device_augment=True)
    ms = time_ms(lambda: train_step.preprocess(dcfg, spec, batch, gen))
    print(f"phase 16 (c): the step's device preprocessing alone "
          f"(train_step.preprocess: the augment of {PRETRAIN_PAIRS} "
          f"canvases, the whole-word masking) {ms:.3f} ms [{card}]")
    runs = device_pretrain_runs(spec, dev, TRAIN_STEPS)
    b, T, I = PRETRAIN_PAIRS, spec.max_text_len, spec.image_len
    want = (fused_pass_launches(spec, b)
            + tower_launches(spec, I, b, rerun=True)
            + tower_launches(spec, T, b, rerun=True)
            + scaled(fused_pass_launches(spec, b), 3))
    return collections.Counter(train_in_turns(
        f"phase 16 (c): VLMo pretrain @{spec.image_size} all_moe ({b} "
        f"pairs; device: uint8 canvases + word ids, host: f32 images + "
        f"masked ids)", runs, batch, b, {"device": want, "host": want},
        card))


def run_preprocess(dev, card: str) -> dict:
    """Phase 16: the canvas eval, the device-augment Trainer and the
    device-preprocessed pretrain step."""
    counts = run_canvas_eval(dev, card)
    torch.cuda.empty_cache()
    counts += run_augment_trainer(dev, card)
    torch.cuda.empty_cache()
    counts += run_device_pretrain(dev, card)
    return {k: counts[k] for k in KERNELS}


# --------------------------------------------------------------------------
# Phase 17: the multi-device dry run and the named configs
# --------------------------------------------------------------------------

# (a) graft_entry.dryrun_multichip at world 4 on the one card under gloo:
# a data 2 x fsdp 2 mesh, the base_vl pretrain at full width, 8 rows a
# rank; of its steps (graft_entry.DRYRUN_STEPS) the first is gated, the
# second timed, the third timed with its collectives
DRYRUN_WORLD = 4
# the gated step against one process on the same card, the same kernels
# and draws: its losses within this relative difference (the reading was
# 9.08e-08), the gathered gradients' global norm within this of one
# process's (with the cosine, which cannot see a scale)
DRYRUN_LOSS_REL, DRYRUN_NORM_TOL = 1e-5, 1e-4
# the state a rank holds: its shards of the params and both moments, half
# of the full f32 state within this share
STATE_SHARE_TOL = 1e-3
# (b) the ViT-L VQA (24 layers, C=1024, 16 heads; vlffn at 21) at the
# 384 px its name carries (the config's own image_size is 224, as the VQA
# fine-tunes train): 21 split layers of 40 + 577 tokens, 3 joint of 617;
# 2 batches of 32 questions, fine-tune steps at micro-batch 8
CONFIG_VQA_L = ("task_finetune_vqa_square_randaug_large_image384_ufo", "ufo")
VQA_L_SIZE, VQA_L_MICRO, VQA_L_SPLIT = 384, 8, 21
# (c) the @224 configs no other phase runs: ImageNet @224 (32 images) and
# the MSR-VTT frame fine-tune (32 pairs, one frame, irtr + ifm + itm)
CONFIG_IMAGENET_224 = ("task_finetune_imagenet_square_randaug_base_image224",)
CONFIG_MSRVTT = ("task_finetune_irtr_msrvtt_frame_square_randaug_base", "ufo")
CONFIGS_BATCH = 32


def pretrain_launches(spec, b: int) -> collections.Counter:
    """One step of mlm, ifm (both towers and their vlffn re-runs) and itm
    (three fused passes) over ``b`` pairs."""
    T, I = spec.max_text_len, spec.image_len
    return (fused_pass_launches(spec, b)                       # mlm
            + tower_launches(spec, I, b, rerun=True)            # ifm
            + tower_launches(spec, T, b, rerun=True)
            + scaled(fused_pass_launches(spec, b), 3))          # itm


def eval_tower_launches(spec, b: int) -> collections.Counter:
    """The retrieval towers (no re-run) over ``b`` images and captions."""
    return (tower_launches(spec, spec.max_text_len, b, train=False)
            + tower_launches(spec, spec.image_len, b, train=False))


@contextlib.contextmanager
def dryrun_stage_context(tmp: str, stage: str):
    """The context of a dry-run rank's stage (``graft_entry.
    dryrun_multichip``): the launches counted from 0 over the stage and
    rank 0's gradients and states (``graft_entry.kept_states``), in what
    it yields; in the step, ITM's hard negatives replayed from
    ``{tmp}/negatives.pt`` (the one-process reference's draws; the
    generator advances as always)."""
    reset_launches()
    real = objectives.sample_hard_negatives
    if stage == "step":
        negatives = torch.load(f"{tmp}/negatives.pt", weights_only=True)

        def replay(sim_i2t, sim_t2i, generator):
            real(sim_i2t, sim_t2i, generator)
            return tuple(n.to(sim_i2t.device) for n in negatives)
        objectives.sample_hard_negatives = replay
    try:
        with graft_entry.kept_states(stage) as extra:
            yield extra
    finally:
        objectives.sample_hard_negatives = real
        extra["launches"] = launches_now()


def row_shares(batch: dict, k: int) -> list:
    """``batch`` cut into its ``k`` row shares, each a batch."""
    return [{key: v.chunk(k)[r] for key, v in batch.items()}
            for r in range(k)]


def dryrun_recall(params, spec, cfg, dev) -> dict:
    """The dry run's recall in this process: its eval set fed as the
    ranks' row shares, each a batch."""
    (text,), (image,), ids = graft_entry.eval_batches(
        spec, graft_entry.FULL_ROWS * DRYRUN_WORLD, None, dev)
    return compute_irtr_recall(eval_cast_params(params, spec, cfg), spec,
                               row_shares(text, DRYRUN_WORLD),
                               row_shares(image, DRYRUN_WORLD), ids, ids)


def run_dryrun(dev, card: str) -> tuple:
    """Phase 17 (a): the one-process reference of the dry run's step (the
    base_vl pretrain at full width over the global batch at dp_scale 1/4,
    its ITM negatives saved for the ranks), then
    ``graft_entry.dryrun_multichip(4)`` on cuda:0 under gloo, each stage
    held against one process; and (c)'s base_vl step, kernel path against
    plain path, timed.  Returns (the ranks' launches, base_vl's)."""
    cfgs = graft_entry.dryrun_configs(DRYRUN_WORLD, full_width=True)
    cfg = cfgs["step"]
    spec = make_model_spec(cfg)
    rows = graft_entry.FULL_ROWS * DRYRUN_WORLD
    if (spec.hidden_size, spec.num_layers, spec.image_len,
            spec.max_text_len, cfg["tasks"]) != (C, 12, N_224, 40, ["vl"]):
        fail("the dry run's config is not the base_vl pretrain at full "
             "width")
    base = graft_entry.seeded_params(spec, dev)
    batch = {k: v.to(dev) for k, v in graft_entry.make_batch(
        spec, rows).items()}
    label = (f"phase 17 (a), one process over the {rows} rows at dp_scale "
             f"1/{DRYRUN_WORLD}")
    with replayed_negatives() as negatives:
        gen = torch.Generator(device=dev).manual_seed(cfg["seed"])
        _, metrics, want_grads = train_step.loss_and_grads(
            master_params(base), spec, cfg, batch, gen, kernels=True,
            dp_scale=1 / DRYRUN_WORLD)
    want = {k: float(v) for k, v in metrics.items() if k.endswith("_loss")}
    print(f"{label}: losses {want}")

    # (c) the base_vl pretrain in one process: kernel path against plain
    n = rows
    over = dict(per_device_batch_size=n, batch_size=n)
    names = (graft_entry.DRYRUN_FULL, "all_moe")
    blabel = f"base_vl pretrain @{spec.image_size} all_moe ({n} pairs)"
    against_plain(blabel, cfg, spec, base, batch, dev)
    base_vl = train_in_turns(
        blabel, objective_runs(names, spec, base, TRAIN_STEPS, **over),
        batch, n, {"kernels": pretrain_launches(spec, n)}, card)
    del base, batch
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        torch.save(tuple(t.cpu() for t in negatives.drawn[0]),
                   f"{tmp}/negatives.pt")
        t0 = time.perf_counter()
        ranks = graft_entry.dryrun_multichip(
            DRYRUN_WORLD, device="cuda:0", backend="gloo", full_width=True,
            stage_context=functools.partial(dryrun_stage_context, tmp))
        wall = time.perf_counter() - t0
    tag = f"phase 17 (a), dryrun_multichip({DRYRUN_WORLD})"
    print(f"{tag}: {wall:.1f} s, the ranks' start included; stage seconds "
          + "; ".join(f"rank {r['rank']} " + ", ".join(
              f"{k} {v:.2f}" for k, v in r["seconds"].items())
              for r in ranks) + f" [{card}]")
    clock = ranks[0]["clock"]
    print(f"{tag}: seconds from the spawn to rank 0's entry "
          f"{clock['entered'] - clock['spawned']:.1f}, its card and group "
          f"{clock['ready'] - clock['entered']:.1f}, its stages "
          f"{clock['done'] - clock['ready']:.1f}, to the join "
          f"{clock['joined'] - clock['done']:.1f}, the results' load "
          f"{clock['loaded'] - clock['joined']:.1f}")

    # the step: losses, gradients, the state each rank holds
    got = ranks[0]["step"]["metrics"]
    rel = max(abs(got[k] - v) / abs(v) for k, v in want.items())
    grads = {k: v.to(dev)
             for k, v in ranks[0]["extra"]["step"]["grads"].items()}
    cos = global_cosine(grads, want_grads)
    norm = global_norm_ratio(grads, want_grads)
    print(f"{tag}: the step's losses {{"
          + ", ".join(f"{k}: {got[k]:.6f}" for k in want)
          + f"}} against one process's: worst relative difference "
          f"{rel:.3e} (need <= {DRYRUN_LOSS_REL}); the averaged gradients "
          f"global cosine {cos:.6f} (need >= {MIN_COSINE}), global norm "
          f"ratio {norm:.7f} (need within {DRYRUN_NORM_TOL} of 1)")
    if rel > DRYRUN_LOSS_REL or cos < MIN_COSINE or \
            abs(norm - 1) > DRYRUN_NORM_TOL or any(
                r["step"]["metrics"] != got for r in ranks):
        fail(f"{tag}: the world-{DRYRUN_WORLD} step disagrees with one "
             f"process's")
    del want_grads, grads
    for r in ranks:
        st = r["step"]
        share = st["held_bytes"] / st["full_bytes"]
        print(f"{tag}, rank {r['rank']} (mesh data {r['mesh'][0]} x fsdp "
              f"{r['mesh'][1]}, {r['backend']}, {r['device']}): the state "
              f"holds {st['held_bytes'] / 2**20:.1f} MiB, {share:.4f} of "
              f"the full f32 state's {st['full_bytes'] / 2**20:.1f} MiB "
              f"({st['sharded']} of {st['params']} params sharded); "
              f"seconds to make the params {st['setup_s']['params']:.1f}, "
              f"to build the step {st['setup_s']['build']:.1f}; step ms "
              + ", ".join(f"{ms:.1f}" for ms in st["step_ms"])
              + f" (gated, timed, with its collectives timed); the timed "
              f"step {st['timed_ms']:.1f} ms; in the last, "
              f"{st['collective_calls']} collectives took "
              f"{st['collective_ms']:.1f} ms, {st['collective_share']:.1%} "
              f"of it [{card}]")
        if r["mesh"] != (2, 2) or st["held_bytes"] != st["shard_bytes"] \
                or abs(share - 0.5) > STATE_SHARE_TOL:
            fail(f"{tag}, rank {r['rank']}: the state is not this rank's "
                 f"half of the full state")

    # the recall, the merge and the merged model's recall
    kept = ranks[0]["extra"]["merge"]
    trained = {k: v.numpy() for k, v in kept["trained"].items()}
    want_rec = dryrun_recall(params_from_numpy(trained, dev), spec, cfg, dev)
    merged, spec_ufo, ufo = graft_entry.merge_to_ufo(trained, cfgs)
    digest = graft_entry.state_digest(merged)
    equal = all(bit_equal(kept["merged"][k].numpy(), v)
                for k, v in merged.items()) and \
        set(kept["merged"]) == set(merged)
    want_merged = dryrun_recall({k: v.to(dev) for k, v in ufo.items()},
                                spec_ufo, cfgs["ufo"], dev)
    print(f"{tag}: recall {ranks[0]['recall']} (one process "
          f"{want_rec}); the merged ufo state's digest {digest[:16]} on "
          f"every rank {all(r['merged_digest'] == digest for r in ranks)}, "
          f"bit-equal to merge_weights in one process {equal}; the merged "
          f"model's recall {ranks[0]['merged_recall']} (one process "
          f"{want_merged})")
    if any(r["recall"] != want_rec or r["merged_recall"] != want_merged
           or r["merged_digest"] != digest for r in ranks) or not equal:
        fail(f"{tag}: the recall or the merge differs from one process's")
    del trained, merged, ufo, kept

    # VQA: one submission, one process's answers
    vcfg = cfgs["vqa"]
    vspec = make_model_spec(vcfg)
    vparams = eval_cast_params(graft_entry.seeded_params(vspec, dev), vspec,
                               vcfg)
    feeds = []
    for feed in graft_entry.vqa_feeds(vspec, rows, None, dev):
        qids = feed.pop("qid")
        for r, part in enumerate(row_shares(feed, DRYRUN_WORLD)):
            share = len(qids) // DRYRUN_WORLD
            feeds.append(dict(part, qid=qids[r * share:(r + 1) * share]))
    want_rets = downstream.vqa_predictions(vparams, vspec, feeds,
                                           graft_entry.vqa_answers(vspec),
                                           scan_k=2)

    def key(rec):
        return rec["question_id"]
    sub = ranks[0]["submission"]
    print(f"{tag}: the VQA submission of {len(sub)} records (rank 0 alone "
          f"{all(r['submission'] is None for r in ranks[1:])}) equal to one "
          f"process's {sorted(sub, key=key) == sorted(want_rets, key=key)}")
    if sorted(sub, key=key) != sorted(want_rets, key=key) or any(
            r["submission"] is not None for r in ranks[1:]):
        fail(f"{tag}: the VQA submission differs from one process's")

    # each rank's launches, stage by stage
    want_stage = {
        "step": scaled(pretrain_launches(spec, graft_entry.FULL_ROWS),
                       graft_entry.DRYRUN_STEPS),
        "recall": eval_tower_launches(spec, graft_entry.FULL_ROWS),
        "merge": eval_tower_launches(spec_ufo, graft_entry.FULL_ROWS),
        "vqa": scaled(fused_pass_launches(vspec, graft_entry.FULL_ROWS,
                                          "tail", train=False), 2)}
    counts = collections.Counter()
    for r in ranks:
        for stage, w in want_stage.items():
            counts.update(check_launches(
                f"{tag}, rank {r['rank']}, {stage}", w,
                r["extra"][stage]["launches"]))
    return {k: counts[k] for k in KERNELS}, base_vl


def run_vqa_large(dev, card: str, rows: dict) -> dict:
    """Phase 17 (b): the ViT-L VQA at full width and depth: the fused pass
    over 2 x 32 questions by "tail" and in W8A8 against the plain path, by
    "qkv" and "mega" against "tail",
    the fine-tune step at micro-batch 8 against the plain path and timed,
    K2 and K9 at 16 heads under the joint mask."""
    cfg = build_config(*CONFIG_VQA_L, overrides=dict(image_size=VQA_L_SIZE))
    spec = make_model_spec(cfg)
    split = sum(mome.splits(b, VL) for b in spec.blocks)
    if (spec.hidden_size, spec.num_heads, spec.max_text_len + spec.image_len,
            split, spec.num_layers) != (C_L, HEADS_L, JOINT_N, VQA_L_SPLIT,
                                        24):
        fail("the ViT-L VQA config is not 24 layers of C=1024, 16 heads, "
             "21 split")
    base = seeded_params(spec, dev)
    params = eval_cast_params(base, spec, cfg)
    batches = vqa_batches(spec, dev)
    n_q = VQA_BATCH * VQA_BATCHES
    id2answer = {i: f"answer {i}" for i in range(spec.vqav2_label_size)}
    label = f"phase 17 (b), ViT-L VQA @384 ({VQA_BATCHES} x {VQA_BATCH})"
    launches = collections.Counter()
    reset_launches()
    rets = downstream.vqa_predictions(params, spec, batches, id2answer)
    launches.update(check_launches(
        f"{label} bf16 'tail'",
        scaled(fused_pass_launches(spec, VQA_BATCH, "tail", train=False),
               VQA_BATCHES)))
    logits_k = torch.cat([downstream.vqa_logits(params, spec, b)
                          for b in batches])
    logits_p = torch.cat([downstream.vqa_logits(params, spec, b,
                                                kernels=False)
                          for b in batches])
    check_cosine(f"{label} bf16 logits", logits_k, logits_p)
    # "qkv" (K8) and "mega" (K7) at C=1024, 16 heads: their deep layers'
    # N=617 under the joint mask (zeros inside the key range)
    for fusion in ("qkv", "mega"):
        reset_launches()
        downstream.vqa_predictions(params, spec, batches, id2answer,
                                   fusion=fusion)
        launches.update(check_launches(
            f"{label} bf16 {fusion!r}",
            scaled(fused_pass_launches(spec, VQA_BATCH, fusion,
                                       train=False), VQA_BATCHES)))
        got = torch.cat([downstream.vqa_logits(params, spec, b,
                                               fusion=fusion)
                         for b in batches])
        equal = torch.equal(got, logits_k)
        err, worst, share = ulp_check("block_eval", got, logits_k)
        print(f"{label} bf16 {fusion!r} logits against 'tail': bit-equal "
              f"{equal}; max |Δ| {err:.3e}, worst {worst:.4f} of the "
              f"{ULPS['block_eval']}-ulp bound, {share:.4f} of them differ")
        if not equal and worst > 1.0:
            fail(f"{label}: the {fusion!r} logits differ from 'tail' beyond "
                 f"{ULPS['block_eval']} ulps")
    cfg8 = build_config(*CONFIG_VQA_L, overrides=dict(
        image_size=VQA_L_SIZE, eval_int8=True))
    spec8 = make_model_spec(cfg8)
    params8 = eval_cast_params(base, spec8, cfg8)
    reset_launches()
    rets8 = downstream.vqa_predictions(params8, spec8, batches, id2answer)
    launches.update(check_launches(
        f"{label} W8A8", scaled(fused_pass_launches(
            spec8, VQA_BATCH, train=False, int8=True), VQA_BATCHES)))
    logits8 = torch.cat([downstream.vqa_logits(params8, spec8, b)
                         for b in batches])
    with int8_plain_path():
        logits8_p = torch.cat([downstream.vqa_logits(params8, spec8, b)
                               for b in batches])
    check_cosine(f"{label} W8A8 logits (the int8 plain path)", logits8,
                 logits8_p)
    print(f"{label}: {len(rets)} answers; W8A8 against bf16 (no gate): "
          f"{sum(a == b for a, b in zip(rets8, rets))} equal")

    def answers(p, s, kernels=True, fusion="tail"):
        return lambda: downstream.vqa_predictions(p, s, batches, id2answer,
                                                  kernels=kernels,
                                                  fusion=fusion)

    rates = rates_in_turns({"bf16 plain": answers(params, spec, False),
                            "bf16 kernels": answers(params, spec),
                            "bf16 'qkv'": answers(params, spec,
                                                  fusion="qkv"),
                            "bf16 'mega'": answers(params, spec,
                                                   fusion="mega"),
                            "W8A8 kernels": answers(params8, spec8)}, n_q)
    print(f"{label}: " + ", ".join(f"{k} {v:.1f} questions/s"
                                   for k, v in rates.items())
          + f" (best of 2, in turns, the bias gather included) [{card}]")
    del params, params8, logits_k, logits_p, logits8, logits8_p
    torch.cuda.empty_cache()

    n = VQA_L_MICRO
    over = dict(per_device_batch_size=n, batch_size=n,
                image_size=VQA_L_SIZE)
    cfg = build_config(*CONFIG_VQA_L, overrides=over)
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    batch = masked_captions(spec, n, dev, gen)
    batch["image"] = torch.randn(n, 3, spec.image_size, spec.image_size,
                                 device=dev, generator=gen)
    batch["vqa_targets"] = torch.rand(n, spec.vqav2_label_size, device=dev,
                                      generator=gen) * (torch.rand(
        n, spec.vqav2_label_size, device=dev, generator=gen) < 0.002)
    slabel = f"phase 17 (b), ViT-L VQA fine-tune @384 ({n} questions)"
    against_plain(slabel, cfg, spec, base, batch, dev)
    launches.update(train_in_turns(
        slabel, objective_runs(CONFIG_VQA_L, spec, base, TRAIN_STEPS,
                               **over),
        batch, n, {"kernels": fused_pass_launches(spec, n)}, card,
        unit="questions"))
    del base
    torch.cuda.empty_cache()
    check_joint_attention(dev, rows, card, heads=HEADS_L,
                          lengths=(N, JOINT_N))
    check_joint_backward(dev, torch.Generator(device=dev).manual_seed(
        SEED + 81), rows, card, heads=HEADS_L)
    return launches


def run_configs_224(dev, card: str) -> collections.Counter:
    """Phase 17 (c): one fine-tune step each of ImageNet @224 and the
    MSR-VTT frame config, kernel path against plain path, then timed in
    turns with their launches."""
    launches = collections.Counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 82)
    n = CONFIGS_BATCH
    over = dict(per_device_batch_size=n, batch_size=n)
    cfg = build_config(*CONFIG_IMAGENET_224, overrides=dict(
        over, pallas_attention=True))
    spec = make_model_spec(cfg)
    if spec.image_len != N_224:
        fail(f"ImageNet @224 has {spec.image_len} image tokens")
    batch = {"image": torch.randn(n, 3, spec.image_size, spec.image_size,
                                  device=dev, generator=gen),
             "class_label": torch.randint(0, spec.img_cls_label_size, (n,),
                                          device=dev, generator=gen)}
    base = seeded_params(spec, dev)
    label = f"phase 17 (c), ImageNet fine-tune @224 ({n} images)"
    against_plain(label, cfg, spec, base, batch, dev)
    launches.update(train_in_turns(
        label, objective_runs(CONFIG_IMAGENET_224, spec, base, TRAIN_STEPS,
                              **over),
        batch, n, {"kernels": tower_launches(spec, spec.image_len, n)}, card,
        unit="images"))
    del base
    cfg = build_config(*CONFIG_MSRVTT, overrides=dict(
        over, pallas_attention=True))
    spec = make_model_spec(cfg)
    if (spec.num_frames, spec.image_len) != (1, N_224):
        fail("the MSR-VTT frame config is not one frame at @224")
    batch = masked_captions(spec, n, dev, gen)
    batch["image"] = torch.randn(n, 3, spec.image_size, spec.image_size,
                                 device=dev, generator=gen)
    T, I = spec.max_text_len, spec.image_len
    want = (tower_launches(spec, I, n) + tower_launches(spec, T, n)  # irtr
            + tower_launches(spec, I, n, rerun=True)                 # ifm
            + tower_launches(spec, T, n, rerun=True)
            + scaled(fused_pass_launches(spec, n), 3))               # itm
    base = seeded_params(spec, dev)
    label = (f"phase 17 (c), MSR-VTT frame fine-tune @224 ufo (irtr, ifm, "
             f"itm; {n} pairs)")
    against_plain(label, cfg, spec, base, batch, dev)
    launches.update(train_in_turns(
        label, objective_runs(CONFIG_MSRVTT, spec, base, TRAIN_STEPS,
                              **over),
        batch, n, {"kernels": want}, card))
    del base
    torch.cuda.empty_cache()
    return launches


def run_entry(dev, card: str) -> collections.Counter:
    """Phase 17: ``graft_entry.entry()`` as a user calls it, on the card at
    its full width (ViT-B/16 all_moe, bf16, 4 pairs): its cls features on
    its f32 masters against the plain path and against its own call on
    their eval cast, its launches as the routing gives them, its ms."""
    label = "phase 17, graft_entry.entry() (ViT-B/16 all_moe bf16, 4 pairs)"
    fn, (params, batch) = graft_entry.entry()
    cfg = build_config(graft_entry.PRETRAIN, "all_moe",
                       overrides={"precision": "bf16"})
    spec = make_model_spec(cfg)
    if (spec.hidden_size, spec.num_layers, spec.image_len,
            next(iter(params.values())).device.type) != (
                C, 12, N_224, "cuda"):
        fail(f"{label}: not the flagship ViT-B at full width on the card")
    reset_launches()
    got = fn(params, batch)
    launches = check_launches(label, fused_pass_launches(
        spec, 4, "tail", train=False))
    if got.shape != (4, C) or got.dtype != torch.bfloat16:
        fail(f"{label}: cls features {tuple(got.shape)} {got.dtype}")
    with torch.no_grad():
        plain = model.infer(params, spec, batch, kernels=False)["cls_feats"]
    check_cosine(label, got, plain)
    cast = eval_cast_params(params, spec, cfg)
    on_cast = fn(cast, batch)
    cos = min_cosine(got, on_cast)
    print(f"{label}: on the f32 masters against the eval-cast params: "
          f"bit-equal {torch.equal(got, on_cast)}, max abs difference "
          f"{(got.float() - on_cast.float()).abs().max().item():.3e}, min "
          f"cosine {cos:.6f} (need >= {MIN_COSINE})")
    if cos < MIN_COSINE:
        fail(f"{label}: the f32 masters and their eval cast disagree")
    ms = {name: time_ms(lambda: fn(p, batch))
          for name, p in (("f32 masters", params), ("eval-cast", cast))}
    print(f"{label}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f" a call ({TIMED_ITERS} back to back) [{card}]")
    return collections.Counter(launches)


def run_dryrun_and_configs(dev, card: str, rows: dict) -> tuple:
    """Phase 17: (a) the dry run with base_vl's one-process step,
    ``graft_entry.entry()``, (b) the ViT-L VQA, (c) ImageNet @224 and
    MSR-VTT; returns (the dry run's launches, the configs' and the
    entry's launches)."""
    dryrun, configs = run_dryrun(dev, card)
    torch.cuda.empty_cache()
    configs = collections.Counter(configs)
    configs.update(run_entry(dev, card))
    configs.update(run_vqa_large(dev, card, rows))
    configs.update(run_configs_224(dev, card))
    return dryrun, {k: configs[k] for k in KERNELS}



# --------------------------------------------------------------------------
# Phase 18: the partial-MoE modes, and the merging suite at ViT-L
# --------------------------------------------------------------------------

# the paper's "which modules to keep per modality" study: each mode
# pretrained, then merged into ufo
PARTIAL_MODES = ("ln_moe", "attn_moe", "ffn_moe")
# (d) each mode's gram pass (f32_device, one batch of 32 pairs) and a
# fleet of 4 on the card; (e) the same at ViT-L @384 all_moe
MODE_GRAM_PAIRS, MODE_FLEET = 32, 4
CONFIG_L_MOE = (CONFIG_L[0], "all_moe")
# (e)'s reckoning: about 12·C² weights per expert-layer over 24 x 2 + 3
# expert-layers and the embeddings, 0.68 G parameters (the grams: 4 per
# expert-layer, 3·C² + (4C)² entries)
L_PARAMS_RECKONED = 0.68e9


def free_g() -> str:
    return subprocess.run(["free", "-g"], capture_output=True,
                          text=True).stdout.strip().replace("\n", " | ")


def run_mode_eval(mode: str, sd, dev, card: str,
                  eval_set) -> collections.Counter:
    """(a) The COCO @384 retrieval eval of the checkpoint ``sd`` in
    ``mode`` by "tail", scored by ``check_merged_eval`` (launches, the
    features and the ITC scores against the plain path, the recall beside
    the plain path's); images/s in turns."""
    cfg = build_config(CONFIG[0], mode)
    spec = make_model_spec(cfg)
    label = (f"phase 18 (a), COCO @384 {mode} eval ({len(eval_set[3])} "
             f"images, {len(eval_set[2])} captions)")
    got = check_merged_eval(sd, spec, cfg, dev, label, eval_set)
    params = eval_cast_params(params_from_numpy(sd, dev), spec, cfg)
    image_batches = eval_set[1]
    rates = rates_in_turns({
        which: (lambda k=which == "kernels": extract_features(
            params, spec, image_batches, "image", kernels=k))
        for which in ("plain", "kernels")}, len(eval_set[3]))
    print(f"{label}: image tower " + ", ".join(
        f"{k} {v:.1f} img/s" for k, v in rates.items())
        + f" (best of 2, in turns) [{card}]")
    return collections.Counter(got)


def run_mode_nlvr2(mode: str, dev, card: str) -> collections.Counter:
    """(b) The NLVR2 @384 fused pass in ``mode`` over 32 pairs: launches
    (the split, whole and composed blocks at the real thresholds), the
    logits against the plain path's, pairs/s in turns."""
    cfg = build_config(CONFIG_NLVR2, mode)
    spec = make_model_spec(cfg)
    params = eval_cast_params(seeded_params(spec, dev, SEED + 52), spec, cfg)
    batch = nlvr2_batch(spec, dev, torch.Generator(device=dev).manual_seed(
        SEED + 53), NLVR2_PAIRS)
    split = sum(mome.splits(b, VL) for b in spec.blocks)
    composed = sum(composed_in_fused_pass(b) for b in spec.blocks)
    label = (f"phase 18 (b), NLVR2 @384 {mode} ({NLVR2_PAIRS} pairs; "
             f"{split} split, {composed} composed, "
             f"{spec.num_layers - split - composed} whole layers)")
    reset_launches()
    with torch.no_grad():
        logits = downstream.nlvr2_logits(params, spec, batch)
    got = check_launches(label, scaled(fused_pass_launches(
        spec, NLVR2_PAIRS, "tail", train=False), 2))
    with torch.no_grad():
        plain = downstream.nlvr2_logits(params, spec, batch, kernels=False)
    # the (B, 2) logits as one vector: a pair's two logits alone may be
    # near zero
    check_cosine(f"{label}: the logits", logits.reshape(1, -1),
                 plain.reshape(1, -1))
    rates = rates_in_turns({
        which: (lambda k=which == "kernels": downstream.nlvr2_predictions(
            params, spec, [batch], kernels=k))
        for which in ("plain", "kernels")}, NLVR2_PAIRS)
    print(f"{label}: " + ", ".join(f"{k} {v:.1f} pairs/s"
                                   for k, v in rates.items())
          + f" (best of 2, in turns) [{card}]")
    return collections.Counter(got)


def run_mode_training(mode: str, dev, card: str) -> collections.Counter:
    """(c) The irtr @384 fine-tune step (32 pairs) and the paper's own
    pretrain @224 (mlm, ifm with its vlffn re-runs, itm with hard
    negatives; 32 pairs) in ``mode``: kernel against plain path, then in
    turns."""
    launches = collections.Counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 54)
    over = dict(per_device_batch_size=MICRO_BATCH, batch_size=MICRO_BATCH)
    names = (CONFIG[0], mode)
    cfg = build_config(*names, overrides=dict(over, pallas_attention=True))
    spec = make_model_spec(cfg)
    images = torch.randn(MICRO_BATCH, 3, spec.image_size, spec.image_size,
                         device=dev, generator=gen)
    ids, masks = synthetic_captions(spec, MICRO_BATCH, dev, gen)
    batch = {"image": images, "text_ids": ids, "text_masks": masks}
    base = seeded_params(spec, dev, SEED + 55)
    label = f"phase 18 (c), irtr fine-tune @384 {mode} ({MICRO_BATCH} pairs)"
    against_plain(label, cfg, spec, base, batch, dev)
    L = spec.num_layers
    launches += train_in_turns(
        label, objective_runs(names, spec, base, TRAIN_STEPS, **over),
        batch, MICRO_BATCH,
        {"kernels": block_launches(N, MICRO_BATCH, L)
         + block_launches(spec.max_text_len, MICRO_BATCH, L)}, card)
    del base
    names = (CONFIG_PRETRAIN[0], mode)
    over = dict(per_device_batch_size=PRETRAIN_PAIRS,
                batch_size=PRETRAIN_PAIRS)
    cfg = build_config(*names, overrides=dict(over, pallas_attention=True))
    spec = make_model_spec(cfg)
    batch = pretrain_batch(spec, cfg, PRETRAIN_PAIRS, dev, gen)
    base = seeded_params(spec, dev, SEED + 56)
    label = (f"phase 18 (c), VLMo pretrain @{spec.image_size} {mode} (mlm, "
             f"ifm, itm; {PRETRAIN_PAIRS} pairs)")
    against_plain(label, cfg, spec, base, batch, dev)
    launches += train_in_turns(
        label, objective_runs(names, spec, base, TRAIN_STEPS, **over),
        batch, PRETRAIN_PAIRS,
        {"kernels": pretrain_launches(spec, PRETRAIN_PAIRS)}, card)
    return launches


def gram_batch(spec, pairs: int, dev, seed: int) -> list:
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids, masks = synthetic_captions(spec, pairs, dev, gen)
    return [{"image": torch.randn(pairs, 3, spec.image_size, spec.image_size,
                                  device=dev, generator=gen),
             "text_ids": ids, "text_masks": masks}]


def merge_suite(names, ufo_names, mode: str, sd, central, dev, card: str,
                tmp: Path, eval_set, *, size: int,
                label: str) -> collections.Counter:
    """The merging suite over the checkpoint ``sd`` (config ``names``,
    written to ``tmp``): the gram pass (f32_device, MODE_GRAM_PAIRS pairs)
    through the taps, ``merge_methods`` into ``ufo_names`` around
    ``central`` (also written), then a fleet of ``size`` and
    ``regmean_device`` on the card."""
    cfg = build_config(*names)
    spec = make_model_spec(cfg)
    moe_path, central_path, gram_path = (str(tmp / f) for f in (
        "moe.ckpt", "central.ckpt", "G.pth"))
    t0 = time.perf_counter()
    save_torch_checkpoint(sd, moe_path)
    back = load_torch_checkpoint(moe_path)
    if set(back) != set(sd) or not all(bit_equal(back[k], sd[k])
                                       for k in sd):
        fail(f"{label}: the checkpoint did not read back bit for bit")
    del back
    if not Path(central_path).exists():
        save_torch_checkpoint(central, central_path)
    print(f"{label}: checkpoint written and read back bit for bit in "
          f"{time.perf_counter() - t0:.2f} s")
    params = params_from_numpy(sd, dev)
    grams, seconds, counts = run_gram_pass(
        params, spec, cfg, gram_batch(spec, MODE_GRAM_PAIRS, dev, SEED + 57),
        "f32_device", f"{label}, f32_device, {MODE_GRAM_PAIRS} pairs", mode)
    del params
    gram_bytes = sum(g.size for g in grams.values()) * 4
    print(f"{label}: gram pass {seconds:.3f} s for {MODE_GRAM_PAIRS} pairs, "
          f"{len(grams)} grams ({gram_bytes / 1e9:.3f} GB in f32), keys as "
          f"the reference taps name them; K2 {spec.num_layers} a batch and "
          f"nothing else [{card}]")
    save_gram_matrices(grams, gram_path)
    n = merge_methods(
        names, ufo_names, moe_path, central_path, gram_path, dev, eval_set,
        tmp, lambda host_regmean: run_device_merging(
            sd, central, grams, host_regmean, spec, dev, card,
            loss_names=cfg["loss_names"], size=size, label=label))
    return collections.Counter(counts) + collections.Counter(n)


def run_partial_modes(dev, card: str) -> collections.Counter:
    """Phase 18 (a)-(d) for each of PARTIAL_MODES at ViT-B/16 width."""
    launches = collections.Counter()
    uspec = make_model_spec(build_config(*CONFIG))
    central = seeded_state(uspec, SEED + 58)
    eval_set = synthetic_eval_set(uspec, dev, torch.Generator(
        device=dev).manual_seed(SEED + 59))
    with tempfile.TemporaryDirectory() as tmp:
        for mode in PARTIAL_MODES:
            t0 = time.perf_counter()
            names = (CONFIG[0], mode)
            spec = make_model_spec(build_config(*names))
            sd = seeded_expert_state(spec, SEED + 60)
            print(f"phase 18, {mode}: seeded checkpoint {len(sd)} tensors, "
                  f"{sum(v.size for v in sd.values()) / 1e6:.1f} M "
                  f"parameters")
            launches += run_mode_eval(mode, sd, dev, card, eval_set)
            launches += run_mode_nlvr2(mode, dev, card)
            launches += run_mode_training(mode, dev, card)
            torch.cuda.empty_cache()
            launches += merge_suite(names, CONFIG, mode, sd, central, dev,
                                    card, Path(tmp), eval_set,
                                    size=MODE_FLEET,
                                    label=f"phase 18 (d), {mode}")
            del sd
            torch.cuda.empty_cache()
            print(f"phase 18, {mode}: {time.perf_counter() - t0:.1f} s "
                  f"[{card}]")
    return launches


def run_merging_large(dev, card: str) -> collections.Counter:
    """Phase 18 (e): the merging suite at ViT-L @384 (C=1024, 24 layers):
    the all_moe checkpoint written and read back, the gram pass (K2 at 16
    heads, N=577), merge.py by each method into ufo and the merged eval
    through K1-K3 at C=1024, a fleet of 4 and regmean_device; the memory
    reckoned first and printed beside the counts."""
    cfg = build_config(*CONFIG_L_MOE)
    spec = make_model_spec(cfg)
    uspec = make_model_spec(build_config(*CONFIG_L))
    if (spec.hidden_size, spec.num_heads, spec.num_layers) != (C_L, HEADS_L,
                                                               24):
        fail("the ViT-L all_moe config is not 24 layers of C=1024, 16 heads")
    label = "phase 18 (e), ViT-L @384 all_moe into ufo"
    t0 = time.perf_counter()
    sd = seeded_expert_state(spec, SEED + 61)
    central = seeded_state(uspec, SEED + 62)
    n = sum(v.size for v in sd.values())
    experts = 2 * spec.num_layers
    gram_entries = experts * (3 * C_L ** 2 + (4 * C_L) ** 2)
    print(f"{label}: {len(sd)} tensors, {n / 1e9:.4f} G parameters, "
          f"{4 * n / 1e9:.3f} GB f32 (reckoned about "
          f"{L_PARAMS_RECKONED / 1e9:.2f} G, "
          f"{4 * L_PARAMS_RECKONED / 1e9:.1f} GB); a fleet of {MODE_FLEET} "
          f"{4 * MODE_FLEET * n / 1e9:.2f} GB on the card and on the host; "
          f"grams reckoned {experts * 4} ({gram_entries * 4 / 1e9:.3f} GB "
          f"f32, twice that in the host's f64); the ufo central "
          f"{sum(v.size for v in central.values()) / 1e9:.4f} G; seeded in "
          f"{time.perf_counter() - t0:.1f} s; free -g: {free_g()}")
    eval_set = synthetic_eval_set(uspec, dev, torch.Generator(
        device=dev).manual_seed(SEED + 63))
    with tempfile.TemporaryDirectory() as tmp:
        launches = merge_suite(CONFIG_L_MOE, CONFIG_L, "all_moe", sd, central,
                               dev, card, Path(tmp), eval_set,
                               size=MODE_FLEET, label=label)
    print(f"{label}: free -g after the suite: {free_g()}")
    return launches


def run_modes_and_large(dev, card: str) -> tuple:
    """Phase 18: (a)-(d) the partial-MoE modes, (e) the merging suite at
    ViT-L; returns the launches of each."""
    modes = run_partial_modes(dev, card)
    torch.cuda.empty_cache()
    large = run_merging_large(dev, card)
    return ({k: modes[k] for k in KERNELS}, {k: large[k] for k in KERNELS})

# The kernels redesigned on wgmma, by the length-prefixed (mangled) names
# of their entry functions in the library's SASS (K7, K14 and K15 by
# width: their instantiations at C=768 and 1024).
# The wgmma instruction each counts: HGMMA (bf16), IGMMA (K14's, K15's and
# K12's s8).
WGMMA_KERNELS = {"K1": "16ln_linear_kernel", "K2": "27packed_attention_fwd_kernel",
                 "K3": "20proj_mlp_tail_kernel", "K4": "22linear_residual_kernel",
                 "K5": "15mlp_tail_kernel", "K6": "17tail_train_kernel",
                 "K7": "17block_eval_kernelILi768E",
                 "K7 C=1024": "17block_eval_kernelILi1024E",
                 "K8": "23ln_qkv_attention_kernel",
                 "K13": "10mlp_kernel", "K9 dq": "9dq_kernel",
                 "K9 dk/dv": "10dkv_kernel", "K14": "19ln_linear_i8_kernelILi768E",
                 "K14 C=1024": "19ln_linear_i8_kernelILi1024E",
                 "K15": "23proj_mlp_tail_i8_kernelILi768E",
                 "K15 C=1024": "23proj_mlp_tail_i8_kernelILi1024E",
                 "K10": "22split_attention_kernel",
                 "K11": "22split_attention_kernel",
                 "K12": "28packed_attention_i8qk_kernel"}
WGMMA_OP = {"K14": "IGMMA", "K14 C=1024": "IGMMA", "K15": "IGMMA",
            "K15 C=1024": "IGMMA", "K12": "IGMMA"}
# The Hopper K1, K2, K7, K8, K14, K15, K10, K11 and K12, whose ptxas report
# is printed and must show no spill (K7: its kernel and every function it
# calls), K7, K14 and K15 at both widths.  K10 and K11 launch one kernel:
# both names match it.
SPILL_FREE = {"ln_linear": "16ln_linear_kernel",
              "packed_attention": "27packed_attention_fwd_kernel",
              "block_eval": "_13_block_eval_cu_",
              "ln_qkv_attention": "23ln_qkv_attention_kernel",
              "ln_linear_i8": "19ln_linear_i8_kernel",
              "proj_mlp_tail_i8": "23proj_mlp_tail_i8_kernel",
              "split_attention": "22split_attention_kernel",
              "split_attention_bb": "22split_attention_kernel",
              "packed_attention_i8qk": "28packed_attention_i8qk_kernel"}
# The sources whose kernels ptxas must not serialise the wgmma of (its
# "wgmma.mma_async instructions are serialized" warning in build/nvcc.log):
# K8, K14, K10/K11, K7 and K15 at both widths, and K12
UNSERIALISED = ("ln_qkv_attention.cu", "ln_linear_i8.cu", "split_attention.cu",
                "block_eval.cu", "proj_mlp_tail_i8.cu",
                "packed_attention_i8qk.cu")
# the kernels whose instantiation at C=1024 the spill check must find
BUILT_AT_1024 = ("block_eval", "ln_linear_i8", "proj_mlp_tail_i8")


def sass_dump(lib) -> tuple:
    """The built library's SASS (``cuobjdump``, from the toolkit that built
    it) written to a temporary file by a process in the background:
    (the process, the file)."""
    fh = tempfile.TemporaryFile(mode="w+")
    return subprocess.Popen([str(Path(_build._nvcc()).with_name("cuobjdump")),
                             "-sass", str(lib)], stdout=fh, text=True), fh


def check_wgmma(dump: tuple) -> None:
    """The redesigned kernels run wgmma: count the HGMMA instructions of
    each in the library's SASS (``sass_dump``, waited for here), IGMMA for
    the int8 ones; fail where one has none, or where K12 has more I2F than
    K2."""
    proc, fh = dump
    if proc.wait() != 0:
        fail(f"cuobjdump exited with {proc.returncode}")
    fh.seek(0)
    out = fh.read()
    fh.close()
    counts, fns = dict.fromkeys(WGMMA_KERNELS, 0), []
    # K12 converts its s32 logits on the integer and FP32 pipes: its SASS
    # has no more I2F than K2's, whose come from the integer divisions that
    # decode an item
    i2f = {"K12": 0, "K2": 0}
    for line in out.splitlines():
        if "Function :" in line:
            fns = [k for k, m in WGMMA_KERNELS.items() if m in line]
        else:
            for fn in fns:
                counts[fn] += WGMMA_OP.get(fn, "HGMMA") in line
                if fn in i2f:
                    i2f[fn] += "I2F" in line
    print("wgmma (HGMMA; K14, K15, K12: IGMMA) instructions in the SASS: "
          + ", ".join(f"{k} {v}" for k, v in counts.items())
          + "; I2F instructions: "
          + ", ".join(f"{k} {v}" for k, v in i2f.items()))
    if not all(counts.values()):
        fail(f"a redesigned kernel has no wgmma in its SASS: {counts}")
    if i2f["K12"] > i2f["K2"]:
        fail(f"more I2F in the SASS of K12 than of K2: {i2f}")


def check_spills() -> dict:
    """The registers and spill bytes ptxas reported for each instantiation
    of K1, K2, K7, K8, K14, K15 and K10/K11 and for every function they call
    (``build/nvcc.log``, written by the build); fail on a spill.  Returns
    a printable summary per kernel."""
    log = (_build.BUILD_DIR / "nvcc.log").read_text()
    found = {name: {} for name in SPILL_FREE}   # name -> function -> [regs, st, ld]
    entry = props = None

    def keys(fn):
        return [n for n, m in SPILL_FREE.items() if m in fn]
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = re.search(r"'([^']+)'", line)[1]
        elif "Function properties for" in line:
            props = line.split("Function properties for", 1)[1].strip()
        elif props and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            for k in keys(props):
                found[k].setdefault(props, [None, 0, 0])[1:] = \
                    [int(m[1]), int(m[2])]
            props = None
        elif entry and "Used" in line and "registers" in line:
            for k in keys(entry):
                found[k].setdefault(entry, [None, 0, 0])[0] = \
                    int(re.search(r"Used (\d+) registers", line)[1])
            entry = None

    def label(fn, name):
        tmpl = re.findall(r"Li(\d+)E", fn.split("I", 1)[-1]) if "ILi" in fn \
            else []
        if name == "proj_mlp_tail_i8" and len(tmpl) == 2:
            return f"C={tmpl[0]} gelu {tmpl[1]} "
        return f"C={tmpl[0]} " if tmpl else ""
    usage = {}
    for n, fns in found.items():
        usage[n] = ", ".join(
            f"{label(fn, n)}{'a called function' if r is None else f'{r} registers'}"
            f", {st} / {ld} bytes spill stores / loads"
            for fn, (r, st, ld) in fns.items())
        print(f"ptxas: {n} {usage[n]}")
    if not all(any(r is not None for r, _, _ in fns.values())
               for fns in found.values()) or \
            any(st or ld for fns in found.values() for _, st, ld in fns.values()):
        fail(f"K1, K2, K7, K8, K14, K15, K10, K11 or K12 spills, or ptxas "
             f"reported none of them: {found}")
    missing = [n for n in BUILT_AT_1024
               if not any("ILi1024E" in fn and r is not None
                          for fn, (r, _, _) in found[n].items())]
    if missing:
        fail(f"ptxas reported no instantiation at C=1024 of {missing}")
    return usage


def check_serialisation() -> None:
    """ptxas's warnings that it serialised the wgmma of a kernel, per
    source (``build/nvcc.log``); fail on one for a source in
    UNSERIALISED."""
    log = (_build.BUILD_DIR / "nvcc.log").read_text()
    warned = {}
    for section in log.split("== ")[1:]:
        name, _, text = section.partition("\n")
        warned[name.strip()] = [line.strip() for line in text.splitlines()
                                if "wgmma" in line and "serializ" in line]
    print("ptxas wgmma serialisation warnings: "
          + ", ".join(f"{n} {len(w)}" for n, w in warned.items() if w or
                      n in UNSERIALISED))
    bad = {n: warned.get(n) for n in UNSERIALISED if warned.get(n)}
    if bad or not all(n in warned for n in UNSERIALISED):
        fail(f"ptxas serialised the wgmma of K8, K14, K10/K11, K7, K15 or "
             f"K12, or built one of them not: {bad}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--digests", action="store_true",
                        help="print only the SHA-256 of the outputs of "
                             "DIGESTED on phase 3's seeded inputs")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = require_cuda()
    card = card_line()
    print(card)
    if opts.digests:
        inputs = digest_inputs(dev)
        for name in DIGESTED:
            print(f"{name} output sha256 on phase 3's seeded inputs "
                  f"{digest(KERNELS[name][0], inputs[name])} [{card}]")
        return 0

    prebuilt = _build.library_path().exists()
    start = t0 = time.perf_counter()
    _build.library()
    print(f"kernels ready in {time.perf_counter() - t0:.1f} s ("
          + ("library already built" if prebuilt else "built by nvcc") + ")")

    # the SASS is dumped beside phase 3 and counted after it
    sass = sass_dump(_build.library_path())
    try:
        return run_phases(dev, card, start, sass)
    finally:
        if sass[0].poll() is None:
            sass[0].kill()
            sass[0].wait()


def run_phases(dev, card: str, start: float, sass: tuple) -> int:
    """Phases 2-18 and the two last lines; ``sass`` the library's SASS
    dump (``sass_dump``), checked after phase 3."""
    usage = check_spills()
    check_serialisation()
    print(f"phases 1-2 (the SASS's wgmma counted after phase 3): "
          f"{time.perf_counter() - start:.1f} s [{card}]")

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(dev, card, *args)
        torch.cuda.empty_cache()
        print(f"phase {phase} ({fn.__name__}): "
              f"{time.perf_counter() - t0:.1f} s [{card}]")
        return out

    rows = timed(3, check_kernels, usage)
    check_wgmma(sass)
    paths = {"eval": timed(4, run_eval),
             "eval_int8": timed(5, run_eval_int8),
             "train": timed(6, run_training),
             "eval_224": timed(7, run_eval_224),
             "train_fusion": timed(8, run_train_fusion),
             "large": timed(9, run_large),
             "tiny": timed(10, run_tiny),
             "merging": timed(11, run_merging),
             "vl": timed(12, run_vl, rows),
             "objectives": timed(13, run_objectives),
             "trainer": timed(14, run_trainer),
             "distribution": timed(15, run_distribution),
             "preprocess": timed(16, run_preprocess)}
    paths["dryrun"], paths["configs"] = timed(17, run_dryrun_and_configs,
                                              rows)
    paths["modes"], paths["merging_large"] = timed(18, run_modes_and_large)
    for name, row in rows.items():
        for path, launches in paths.items():
            row[f"launches_{path}"] = launches[name]
        row["launches"] = sum(launches[name] for launches in paths.values())
        if row["launches"] == 0:
            fail(f"{name} was launched no time on the main paths")
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - start:.1f} s, the build included [{card}]")
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
