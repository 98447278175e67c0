"""The port's Trainer and CLIs (``train/loop.py``, ``run.py``,
``cache_gram_matrices.py``) against the JAX package's, on the CPU.

Both packages load one seeded ``weights.ckpt`` per config through
``load_path`` (every param of the schema, so no side keeps a random init
of its own), at ViT-tiny widths (hidden 32, 2 heads, 2 layers, 64-px
images, 16 text tokens), f32, no dropout.  The JAX Trainer runs on a
one-device mesh (``num_devices=1``), the port's with ``use_cpu=True``;
``per_device_batch_size`` equals ``batch_size``, so both take one
micro-batch a step.

The JAX Trainer scales ``ifm_loss`` and ``irtr_loss`` by
``1/jax.device_count()`` (1/8 on the test mesh; the port's ``dp_scale``
is 1 at one device), so the fitted params are compared on NLVR2, within
``lr/4`` per step (f32: Adam turns gradients that differ in their last
bits into updates that differ by up to a share of the learning rate;
``test_torch_port_train.py``).  For irtr: the batches each Trainer's
steps take (bit for bit), the step and validation cadence, the keys of
``metrics.jsonl``, ``val/the_metric`` and R@k before the fit
(identical); the VQA submission of ``test()`` (identical);
``weights.ckpt`` read across packages (bit for bit); a resumed fit
against an uninterrupted one (bit for bit, with dropout and stochastic
depth on); the gram CLI's grams within 1e-5 of each gram's largest entry
(f32 activations summed in another order); and the Trainer's raises.
"""

import json
import os

import numpy as np
import pytest
import torch

from fixtures import make_fixture_root
from vl_merging_tpu import cache_gram_matrices as jgram_cli
from vl_merging_tpu import run as jrun
from vl_merging_tpu.ckpt import io as jckpt_io
from vl_merging_tpu.config import build_config as jbuild_config
from vl_merging_tpu.data import datamodule as jdatamodule
from vl_merging_tpu.train import loop as jloop
from vl_merging_tpu_torch import cache_gram_matrices as gram_cli
from vl_merging_tpu_torch import run
from vl_merging_tpu_torch.ckpt import io as ckpt_io
from vl_merging_tpu_torch.config import build_config
from vl_merging_tpu_torch.data import datamodule
from vl_merging_tpu_torch.models.spec import init_params, make_model_spec
from vl_merging_tpu_torch.train import loop, train_step
from torch_port_threads import one_torch_thread  # noqa: F401

IRTR = ("task_finetune_irtr_coco_square_randaug_base_image384", "ufo")
NLVR2 = ("task_finetune_nlvr2_square_randaug_base_image384", "ufo")
VQA = ("task_finetune_vqa_square_randaug_base_image384_ufo", "ufo")
GRAMS = ("task_finetune_irtr_coco_square_randaug_base_image384", "all_moe")
LR = 1e-4
GRAM_REL = 1e-5


def tiny(root, log_dir, **over):
    o = dict(data_root=root, log_dir=log_dir,
             tokenizer=os.path.join(root, "vocab.txt"), hidden_size=32,
             num_heads=2, num_layers=2, image_size=64, patch_size=16,
             max_text_len=16, max_text_len_of_initckpt=16,
             vlffn_start_layer_index=1, precision="f32", drop_rate=0.0,
             per_device_batch_size=4, batch_size=4, num_workers=0,
             max_steps=2, warmup_steps=0, learning_rate=LR,
             max_vl_text_len=None, num_devices=1,
             train_transform_keys=["square_transform"],
             val_transform_keys=["square_transform"])
    o.update(over)
    return o


def argv(names, over, port: bool):
    """CLI arguments; the port's ask for the CPU."""
    over = dict(over, use_cpu=True) if port else over
    return list(names) + [f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"
                          for k, v in over.items()]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_fixture_root(tmp_path_factory.mktemp("port_trainer"))


@pytest.fixture(scope="module")
def weights(root, tmp_path_factory):
    """One seeded checkpoint per config, every param of its schema."""
    out = {}
    d = tmp_path_factory.mktemp("weights")
    for i, names in enumerate((IRTR, NLVR2, VQA, GRAMS)):
        spec = make_model_spec(build_config(*names, overrides=tiny(root, "")))
        params = init_params(spec, torch.Generator().manual_seed(i))
        gen = torch.Generator().manual_seed(100 + i)
        params = {k: v + 0.02 * torch.randn(v.shape, generator=gen)
                  for k, v in params.items()}
        path = str(d / f"{i}" / "weights.ckpt")
        ckpt_io.save_torch_checkpoint(ckpt_io.params_to_state_dict(params),
                                      path)
        out[names] = path
    return out


def only_dir(log_dir):
    (exp,) = os.listdir(log_dir)
    return os.path.join(log_dir, exp)


def metrics_lines(log_dir):
    with open(os.path.join(only_dir(log_dir), "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def recorded(trainer_cls, filt):
    """A Trainer that records the host batches of each optimizer step and
    the step of each validation."""

    class Recording(trainer_cls):
        def _stack_micro(self, micro_buf):
            self.fed.append([filt(b) for b in micro_buf])
            return super()._stack_micro(micro_buf)

        def _validate_and_checkpoint(self, dm, step, final=False):
            self.validated.append(step)
            return super()._validate_and_checkpoint(dm, step, final=final)

    def make(cfg):
        t = Recording(cfg)
        t.fed, t.validated = [], []
        return t

    return make


def test_irtr_fit_cadence_logs_recall_and_checkpoints(root, weights,
                                                      tmp_path):
    over = tiny(root, "", load_path=weights[IRTR], max_steps=3,
                val_check_interval=2, get_recall_metric=True)
    trainers = {}
    for side, build, mod, dmod in (
            ("jax", jbuild_config, jloop, jdatamodule),
            ("port", build_config, loop, datamodule)):
        cfg = build(*IRTR, overrides=dict(
            over, log_dir=str(tmp_path / side),
            **({"use_cpu": True} if side == "port" else {})))
        t = recorded(mod.Trainer, mod.host_filter)(cfg)
        dm = dmod.MTDataModule(cfg)
        t.recall_before = t.recall(dm)
        t.fit(dm)
        trainers[side] = t
    j, t = trainers["jax"], trainers["port"]
    assert t.recall_before == j.recall_before
    # the steps' batches, bit for bit, and the cadence: validation after
    # step 2 (val_check_interval 2 loader batches) and after the last
    assert len(t.fed) == len(j.fed) == 3
    for fj, ft in zip(j.fed, t.fed):
        for bj, bt in zip(fj, ft):
            assert set(bj) == set(bt)
            for k in bj:
                assert bj[k].dtype == bt[k].dtype and \
                    bj[k].tobytes() == bt[k].tobytes(), k
    assert t.validated == j.validated == [2, 3]
    lj, lt = metrics_lines(tmp_path / "jax"), metrics_lines(tmp_path /
                                                            "port")
    assert [sorted(r) for r in lt] == [sorted(r) for r in lj]
    assert [r["step"] for r in lt] == [2, 3]
    # the_metric: the test split's ir_r1 + tr_r1 (irtr's accuracy has no
    # count in the eval metrics, in either package); after the fit the
    # params differ by the JAX package's 1/8 contrastive gradient scale
    for r in lt:
        assert r["val/the_metric"] == r["val/ir_r1"] + r["val/tr_r1"]
    # checkpoints: last and best, read across packages bit for bit
    for side, tr, read in (("port", t, jckpt_io.load_torch_checkpoint),
                           ("jax", j, ckpt_io.load_torch_checkpoint)):
        ck = os.path.join(only_dir(tmp_path / side), "checkpoints")
        assert os.path.exists(os.path.join(ck, "best", "weights.ckpt"))
        sd = read(os.path.join(ck, "last", "weights.ckpt"))
        params = (tr.params if side == "port" else tr.state.params)
        assert set(sd) == set(params)
        for k, v in params.items():
            want = (v.detach().numpy() if side == "port" else np.asarray(v))
            assert sd[k].dtype == want.dtype and \
                sd[k].tobytes() == want.tobytes(), k
        with open(os.path.join(ck, "last", "meta.json")) as f:
            assert json.load(f)["step"] == 3
    assert os.path.exists(os.path.join(only_dir(tmp_path / "port"),
                                       "checkpoints", "last", "state.pt"))


def test_nlvr2_fit_through_run_matches_jax(root, weights, tmp_path):
    over = tiny(root, "", load_path=weights[NLVR2], max_steps=1,
                datasets=["nlvr2"])
    jrun.main(argv(NLVR2, dict(over, log_dir=str(tmp_path / "jax")), False))
    trainer = run.main(argv(NLVR2, dict(over, log_dir=str(tmp_path /
                                                          "port")), True))
    assert trainer.state.step == 1
    fitted = {}
    for side, read in (("jax", jckpt_io.load_torch_checkpoint),
                       ("port", ckpt_io.load_torch_checkpoint)):
        fitted[side] = read(os.path.join(only_dir(tmp_path / side),
                                         "checkpoints", "last",
                                         "weights.ckpt"))
    start = ckpt_io.load_torch_checkpoint(weights[NLVR2])
    worst = 0.0
    for k, v in fitted["jax"].items():
        d = np.abs(fitted["port"][k] - v).max()
        worst = max(worst, d)
        assert d <= LR / 4, (k, d)
    moved = max(np.abs(fitted["port"][k] - start[k]).max() for k in start
                if k in fitted["port"])
    assert moved > 10 * worst
    lj, lt = metrics_lines(tmp_path / "jax"), metrics_lines(tmp_path /
                                                            "port")
    assert [sorted(r) for r in lt] == [sorted(r) for r in lj]
    for rj, rt in zip(lj, lt):   # the NLVR2 dev/test split tallies
        for k in rj:
            if k.endswith("accuracy") or k == "val/the_metric":
                assert rt[k] == rj[k], k


def test_vqa_test_only_submission_matches_jax(root, weights, tmp_path):
    over = tiny(root, "", load_path=weights[VQA], datasets=["vqa"],
                test_only=True)
    jrun.main(argv(VQA, dict(over, log_dir=str(tmp_path / "jax")), False))
    run.main(argv(VQA, dict(over, log_dir=str(tmp_path / "port")), True))
    subs = {}
    for side in ("jax", "port"):
        path = os.path.join(only_dir(tmp_path / side),
                            "vqa_submit_weights.json")
        with open(path) as f:
            subs[side] = json.load(f)
    assert subs["port"] and subs["port"] == subs["jax"]


def test_gram_cli_matches_jax(root, weights, tmp_path):
    over = tiny(root, "", load_path=weights[GRAMS], datasets=["coco"],
                loss_names={"ifm": 1}, representation_name="G",
                per_device_batch_size=8)
    jgram_cli.main(argv(GRAMS, dict(over, log_dir=str(tmp_path / "jax")),
                        False))
    out = gram_cli.main(argv(GRAMS, dict(over, log_dir=str(tmp_path /
                                                           "port")), True))
    gj = torch.load(str(tmp_path / "jax" / "G.pth"), weights_only=True)
    gt = torch.load(out, weights_only=True)
    assert set(gt) == set(gj) and "transformer.blocks.1.mlp.vl.fc2" in gt
    for k, v in gj.items():
        assert gt[k].dtype == torch.float64 and gt[k].shape == v.shape
        assert (gt[k] - v).abs().max() <= GRAM_REL * v.abs().max(), k


def test_resume_equals_an_uninterrupted_fit(root, weights, tmp_path,
                                            monkeypatch):
    """Two micro-batches a step, dropout and stochastic depth on: a fit
    stopped after its step-3 checkpoint and resumed from it takes the
    uninterrupted fit's steps 4-6 (across an epoch's end) bit for bit."""
    over = tiny(root, "", load_path=weights[IRTR], max_steps=6,
                per_device_batch_size=2, batch_size=4, drop_rate=0.1,
                val_check_interval=6, use_cpu=True)

    class Stop(Exception):
        pass

    def fit(log_dir, stop_at=None, **more):
        """(trainer, [(step, total loss)]); with ``stop_at`` the fit stops
        right after the checkpoints of that step's validation."""
        cfg = build_config(*IRTR, overrides=dict(over, log_dir=log_dir,
                                                 **more))
        trainer = loop.Trainer(cfg)
        losses = []

        def build_step(max_steps):
            loop.Trainer._build_step(trainer, max_steps)
            step_fn = trainer.step_fn

            def step(state, feed):
                state, m = step_fn(state, feed)
                losses.append((state.step, m["total_loss"].item()))
                return state, m
            trainer.step_fn = step

        def validate_and_checkpoint(dm, step, final=False):
            loop.Trainer._validate_and_checkpoint(trainer, dm, step, final)
            if step == stop_at:
                raise Stop

        trainer._build_step = build_step
        trainer._validate_and_checkpoint = validate_and_checkpoint
        assert trainer.accum_steps == 2
        try:
            trainer.fit(datamodule.MTDataModule(cfg))
        except Stop:
            pass
        return trainer, losses

    whole, whole_losses = fit(str(tmp_path / "whole"))
    _, first = fit(str(tmp_path / "parts"), stop_at=3)
    resumed, rest = fit(str(tmp_path / "parts"),
                        resume_during_pretraining=True)
    assert [s for s, _ in whole_losses] == list(range(1, 7))
    assert first + rest == whole_losses
    assert resumed.state.step == 6
    for k, v in whole.params.items():
        assert torch.equal(resumed.params[k], v), k
    for a, b in ((resumed.state.opt_state.mu, whole.state.opt_state.mu),
                 (resumed.state.opt_state.nu, whole.state.opt_state.nu)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(resumed.state.generator.get_state(),
                       whole.state.generator.get_state())
    # the validations after the resume (step 4 at the epoch's end, step 6
    # the last) log what the uninterrupted fit logs
    def vals(log_dir):
        return {r["step"]: r for r in metrics_lines(log_dir)
                if "val/the_metric" in r}
    got, want = vals(tmp_path / "parts"), vals(tmp_path / "whole")
    assert sorted(want) == [3, 4, 6] and sorted(got) == [3, 4, 6]
    assert all(got[s] == want[s] for s in (4, 6))


@pytest.mark.parametrize("over, item", [
    (dict(num_devices=2), "Distribution"),
    (dict(use_sharded_training=True), "Distribution"),
    (dict(device_augment=True), "In-graph preprocessing"),
    (dict(device_mlm=True), "In-graph preprocessing"),
])
def test_trainer_raises_for_what_is_not_ported(root, over, item, tmp_path):
    """Both items are ported.  "Distribution": in one process
    ``num_devices=2`` is refused, naming both counts, and
    ``use_sharded_training`` trains unsharded (an fsdp axis of 1, as the
    JAX Trainer's mesh at an odd device count).  "In-graph
    preprocessing": the Trainer builds; under ``device_mlm`` it takes the
    [MASK] id from the datamodule's tokenizer, under ``device_augment`` a
    train batch's uint8 canvas takes its host draws from the Trainer's
    stream."""
    cfg = build_config(*IRTR, overrides=tiny(root, str(tmp_path),
                                             use_cpu=True, **over))
    if item != "Distribution":
        trainer = loop.Trainer(cfg)
        dm = datamodule.MTDataModule(cfg)
        if "device_mlm" in over:
            trainer._bind_tokenizer(dm)
            assert cfg["mask_token_id"] == \
                dm.mlm_collator.tokenizer.mask_token_id
        else:
            batch = train_step.attach_augment_params(
                next(iter(dm.train_loader(2))), cfg, trainer._aug_rng)
            assert batch["image_canvas"].dtype == np.uint8
            assert {"aug_crop", "aug_op_idx"} <= set(batch)
            assert "image_sizes" not in batch and "image" not in batch
        trainer.logger.close()
    elif "num_devices" in over:
        with pytest.raises(ValueError, match=r"num_devices=2.* 1 process"):
            loop.Trainer(cfg)
    else:
        trainer = loop.Trainer(cfg)
        assert (trainer.mesh.data, trainer.mesh.fsdp) == (1, 1)
        trainer.logger.close()


def test_trainer_and_gram_cli_need_the_card_unless_asked(root, weights,
                                                         monkeypatch,
                                                         tmp_path):
    """Without ``use_cpu=True`` the entry points ask for the card and
    raise where there is none; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    over = tiny(root, str(tmp_path), load_path=weights[GRAMS],
                datasets=["coco"])
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.Trainer(build_config(*IRTR, overrides=dict(over)))
    with pytest.raises(RuntimeError, match="CUDA"):
        gram_cli.main(argv(GRAMS, over, False))
