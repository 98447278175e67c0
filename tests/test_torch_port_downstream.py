"""The port's downstream eval (``evaluation/downstream.py``,
``evaluation/metrics.py``, the ITM rerank of ``evaluation/retrieval.py``,
and the VQA and NLVR2 objectives at ``train=False``) against the JAX
package, on the CPU in f32.

Tiny specs (C=128, 2 heads of 64, 2 layers with ``vlffn_start_layer_index
=1``, 64-px images, 8 text tokens, seeded numpy params) in ufo.  Logits,
log-probabilities and losses agree with the JAX package to ``TOWER_TOL``
(atol 2e-5, rtol 1e-4).  Answer ids are held equal wherever the JAX
logits' top-2 gap exceeds that tolerance (below it, two packages that
agree to the tolerance may pick either answer); every gap here exceeds
it, so every answer, recall dict, count and metric is held equal.  Each
case runs with ``kernels=False`` and with the routing thresholds at 0
(the K1-K3 and K13 twins).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vl_merging_tpu.evaluation import downstream as jdownstream
from vl_merging_tpu.evaluation import metrics as jmetrics
from vl_merging_tpu.evaluation import retrieval as jretrieval
from vl_merging_tpu.train import train_step as jtrain_step
from vl_merging_tpu_torch.evaluation import downstream, metrics, retrieval
from vl_merging_tpu_torch.models import mome
from vl_merging_tpu_torch.ops import fused_block as TF
from vl_merging_tpu_torch.train import train_step
from test_torch_port_vl import TOWER_TOL, jbatch, setup, tbatch, vl_inputs
from torch_port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _tiny_width_is_built(monkeypatch):
    monkeypatch.setattr(TF, "KERNEL_WIDTHS", {
        k: v + (128,) for k, v in TF.KERNEL_WIDTHS.items()})


@pytest.fixture(params=["plain", "kernel twins"])
def routing(request, monkeypatch):
    """kernels=False, or the thresholds at 0 (the K1-K3 and K13 twins)."""
    if request.param == "kernel twins":
        monkeypatch.setattr(mome, "KERNEL_MIN_N", 0)
        monkeypatch.setattr(mome, "MLP_MIN_ROWS", 0)
    return dict(kernels=request.param != "plain")


def _tiny(task, losses):
    """(cfg, JAX spec, port spec, JAX params, port params) of ``task`` in
    ufo with ``losses``, through the VL tests' seeded setup."""
    cfg, jspec, spec, _, jparams, params = setup("ufo", task=task,
                                                 losses=losses)
    return cfg, jspec, spec, jparams, params


IRTR = "task_finetune_irtr_coco_square_randaug_base_image384"
VQA = "task_finetune_vqa_square_randaug_base_image384_ufo"
NLVR2 = "task_finetune_nlvr2_square_randaug_base_image384"
N_IMG, CAPS = 6, 3


def assert_close(got, want, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **TOWER_TOL,
                               err_msg=err_msg)


def top2_gap(logits) -> np.ndarray:
    top = np.sort(np.asarray(logits, np.float64), axis=-1)
    return top[..., -1] - top[..., -2]


def assert_gaps_exceed_tolerance(logits):
    """The premise of holding answer ids equal: every top-2 gap of the
    JAX logits exceeds the tolerance at the top logit."""
    top = np.abs(np.asarray(logits)).max(-1)
    assert (top2_gap(logits) > TOWER_TOL["atol"] +
            TOWER_TOL["rtol"] * top).all()


def jax_losses(cfg, jspec, jparams, b):
    """The JAX package's eval-mode ``compute_losses`` under ``jit``, one
    trace per spec."""
    if jspec not in _JAX_LOSSES:
        _JAX_LOSSES[jspec] = jax.jit(lambda p, x: jtrain_step.compute_losses(
            p, jspec, cfg, x, jax.random.PRNGKey(0), train=False))
    return _JAX_LOSSES[jspec](jparams, jbatch(b))


_JAX_LOSSES = {}


def _retrieval_set():
    rng = np.random.RandomState(3)
    images = rng.randn(N_IMG, 3, 64, 64).astype(np.float32)
    n = N_IMG * CAPS
    ids = rng.randint(0, 30522, (n, 8)).astype(np.int32)
    masks = np.ones((n, 8), np.int32)
    for i, m in enumerate(rng.randint(3, 9, n)):
        masks[i, m:] = 0
    return images, ids, masks


@pytest.mark.parametrize("axis", [1, 0])
def test_itm_rerank_scores_match_jax(axis, routing):
    """Candidates by ITC, chunks of pair_batch // topk queries (the last
    padded), the ITM log-probabilities scattered at 1e4 and the rest at
    ITC − 1e8."""
    cfg, jspec, spec, jparams, params = _tiny(IRTR, ("irtr", "itm"))
    images, ids, masks = _retrieval_set()
    rng = np.random.RandomState(4)
    scores = rng.randn(N_IMG, N_IMG * CAPS).astype(np.float32)
    scores[0, :4] = scores[0, 4]          # ties go to the lower index
    want = np.asarray(jretrieval.itm_rerank_scores(
        jparams, jspec, jnp.asarray(ids), jnp.asarray(masks),
        jnp.asarray(images), jnp.asarray(scores), 3, axis=axis,
        pair_batch=8))
    got = retrieval.itm_rerank_scores(
        params, spec, torch.from_numpy(ids), torch.from_numpy(masks),
        torch.from_numpy(images), torch.from_numpy(scores), 3, axis=axis,
        pair_batch=8, **routing).numpy()
    reranked = want > -1e7
    np.testing.assert_array_equal(got > -1e7, reranked)
    assert reranked.sum() == 3 * scores.shape[1 - axis]
    assert_close(got[reranked] / 1e4, want[reranked] / 1e4)
    np.testing.assert_array_equal(got[~reranked], want[~reranked])


def test_compute_irtr_recall_with_rerank_matches_jax(routing):
    cfg, jspec, spec, jparams, params = _tiny(IRTR, ("irtr", "itm"))
    images, ids, masks = _retrieval_set()
    tiids, iids = np.repeat(np.arange(N_IMG), CAPS), np.arange(N_IMG)
    half = len(ids) // 2
    text = [dict(text_ids=ids[s], text_masks=masks[s])
            for s in (slice(0, half), slice(half, None))]
    want = jretrieval.compute_irtr_recall(
        jparams, jspec, [jbatch(t) for t in text],
        [{"image": jnp.asarray(images)}], tiids, iids, itm_rerank_topk=4)
    got = retrieval.compute_irtr_recall(
        params, spec, [tbatch(t) for t in text],
        [{"image": torch.from_numpy(images)}], tiids, iids,
        itm_rerank_topk=4, **routing)
    assert got == want


def _vqa_batches():
    """Four batches of 3 questions and a tail of 2, with question ids."""
    out = []
    for i, n in enumerate((3, 3, 3, 3, 2)):
        b = vl_inputs(seed=10 + i, n=n)
        out.append({"text_ids": b["text_ids"], "text_masks": b["text_masks"],
                    "image": b["image_0"],
                    "qid": list(range(100 * i, 100 * i + n))})
    return out


def test_vqa_predictions_match_jax(routing, tmp_path):
    """Answer ids by argmax after the VQA head, every scan_k grouping the
    same records, and the submission json equal to the JAX package's."""
    cfg, jspec, spec, jparams, params = _tiny(VQA, ("vqa",))
    batches = _vqa_batches()
    id2answer = {i: f"answer {i}" for i in range(spec.vqav2_label_size)}
    jfeeds = [dict(jbatch({k: v for k, v in b.items() if k != "qid"}),
                   qid=b["qid"]) for b in batches]
    logits = [jdownstream.make_vqa_logits_fn(jspec)(
        jparams, {k: v for k, v in f.items() if k != "qid"}) for f in jfeeds]
    for lg in logits:
        assert_gaps_exceed_tolerance(lg)
    want = jdownstream.vqa_predictions(jparams, jspec, jfeeds, id2answer)
    want_path = jdownstream.write_vqa_submission(want, "tiny",
                                                 str(tmp_path / "jax"))
    tfeeds = [dict(tbatch({k: v for k, v in b.items() if k != "qid"}),
                   qid=b["qid"]) for b in batches]
    for b, lg in zip(tfeeds, logits):
        assert_close(downstream.vqa_logits(params, spec, b, **routing), lg)
    for scan_k in (1, 3):
        got = downstream.vqa_predictions(params, spec, tfeeds, id2answer,
                                         scan_k=scan_k, **routing)
        assert got == want
        path = downstream.write_vqa_submission(
            got, "tiny", str(tmp_path / f"port{scan_k}"))
        assert open(path).read() == open(want_path).read()
        assert json.load(open(path))[4] == {"question_id": 101,
                                            "answer": want[4]["answer"]}


def _nlvr2_batch(seed=20, n=4):
    b = vl_inputs(seed=seed, n=n)
    b["answers"] = np.array([0, 1, 1, 0][:n], np.int32)
    return b


def test_nlvr2_paired_pass_split_and_metric_match_jax(routing):
    """The paired pass (types 1 and 2), its dev/test split by table name
    through both packages' accumulators, and the_metric's test-split
    quirk."""
    cfg, jspec, spec, jparams, params = _tiny(NLVR2, ("nlvr2",))
    batches = [_nlvr2_batch(20), _nlvr2_batch(21)]
    jout = [jax_losses(cfg, jspec, jparams, b) for b in batches]
    tables = ["dev-1", "test1-0", "dev-3", "test1-2"]
    jacc, acc = jmetrics.MetricAccumulator(), metrics.MetricAccumulator()
    preds = downstream.nlvr2_predictions(params, spec,
                                         [tbatch(b) for b in batches],
                                         **routing)
    for b, jo in zip(batches, jout):
        assert_gaps_exceed_tolerance(jo["nlvr2_logits"])
        got = downstream.nlvr2_logits(params, spec, tbatch(b), **routing)
        assert_close(got, jo["nlvr2_logits"])
        jdownstream.nlvr2_split_update(jacc, np.asarray(jo["nlvr2_logits"]),
                                       b["answers"], tables)
        downstream.nlvr2_split_update(acc, got, torch.from_numpy(
            b["answers"]), tables)
        for a, o in ((jacc, jo), (acc, jo)):
            a.update({"nlvr2_loss": float(o["nlvr2_loss"])})
    np.testing.assert_array_equal(preds.numpy(), np.concatenate(
        [np.asarray(jo["nlvr2_logits"]).argmax(-1) for jo in jout]))
    assert acc.compute() == jacc.compute()
    for loss_names, recall in (({"nlvr2": 1}, None), ({"nlvr2": 1, "irtr": 1},
                                                     {"ir_r1": 0.5})):
        assert metrics.the_metric(loss_names, acc.compute(), recall) == \
            jmetrics.the_metric(loss_names, jacc.compute(), recall)
    assert metrics.the_metric({"nlvr2": 1}, acc.compute()) == \
        acc.compute()["test_nlvr2_accuracy"]


def test_vqa_and_nlvr2_objectives_match_jax_at_eval(routing):
    """compute_losses(train=False) runs vqa and nlvr2 (the eval step and
    the gram pass) as the JAX package does; without a generator
    train=True draws nothing and gives the same losses (the training step
    against the JAX package: ``test_torch_port_finetune.py``)."""
    for task, loss in ((VQA, "vqa"), (NLVR2, "nlvr2")):
        cfg, jspec, spec, jparams, params = _tiny(task, (loss,))
        b = _nlvr2_batch()
        b["image"] = b["image_0"]
        b["vqa_targets"] = np.random.RandomState(5).rand(
            4, spec.vqav2_label_size).astype(np.float32) * (
            np.random.RandomState(6).rand(4, spec.vqav2_label_size) < 0.01)
        want = jax_losses(cfg, jspec, jparams, b)
        got = train_step.compute_losses(params, spec, cfg, tbatch(b), None,
                                        train=False, **routing)
        assert set(got) == set(want)
        for k, w in want.items():
            if isinstance(got[k], int):
                assert got[k] == int(w), k
            else:
                assert_close(got[k].float(), np.asarray(w, np.float32), k)
        trained = train_step.compute_losses(params, spec, cfg, tbatch(b),
                                            None, train=True, **routing)
        assert_close(trained[f"{loss}_loss"].float(),
                     np.asarray(want[f"{loss}_loss"], np.float32),
                     f"{loss}_loss at train=True")


def test_one_process_only(tmp_path):
    """Without a process group the JAX package's multi-process branches
    are the one-process paths: the tallies' reduction is a no-op, the
    submission is the one json of the records, and the predictions of no
    batch are none (their two-rank runs: ``test_torch_port_distributed.
    py``)."""
    acc = metrics.MetricAccumulator()
    acc.update({"dev_nlvr2_correct": 1.0, "dev_nlvr2_count": 2.0})
    acc.cross_process_reduce(["dev_nlvr2_correct"])
    assert acc.compute() == {"dev_nlvr2_accuracy": 0.5}
    rets = [{"question_id": 1, "answer": "yes"}]
    path = downstream.write_vqa_submission(rets, "m", str(tmp_path))
    assert path == str(tmp_path / "vqa_submit_m.json")
    assert json.load(open(path)) == rets
    assert sorted(p.name for p in tmp_path.iterdir()) == ["vqa_submit_m.json"]
    assert downstream.vqa_predictions({}, None, [], {}) == []
