"""Device-side MLM masking, i.i.d. and whole-word (port of
``vl_merging_tpu/ops/text_masking.py``).

Semantics of ``data/collators.MLMCollator`` (HF's
DataCollatorForLanguageModeling / DataCollatorForWholeWordMask, which the
reference applies in its collate: src/vilt/datasets/base_dataset.py:
204-253, src/vilt/datamodules/datamodule_base.py:64-72):

  * candidate positions are the non-special, non-padding tokens;
  * i.i.d.: each candidate masked with p = mlm_prob;
  * whole-word: '##' continuations group with their word (the collator
    emits the RNG-free ``word_ids`` map); whole words are taken in a
    random order while they fit within round(n_candidates · mlm_prob)
    tokens (HF's greedy-with-skip loop: a skipped word takes no budget);
  * replacement: 80% [MASK], 10% a random token, 10% unchanged;
  * labels: the original ids at masked positions, -100 elsewhere.

Each function is split into its draws (``mlm_draws``, uniforms and random
tokens from a ``torch.Generator`` through ``models/layers.rank_rand``, so
the ranks of a process group draw what one process draws over the global
batch) and a deterministic core that takes them (``apply_mlm``), which
replays the JAX package's ``jax.random`` draws bit for bit in the tests.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.layers import rank_rand

IGNORE = -100


def budget_table(length: int, mlm_prob: float,
                 max_predictions: int = 512) -> torch.Tensor:
    """(length + 1,) int64: the whole-word budget of each candidate count,
    min(max_predictions, max(1, int(round(n * mlm_prob)))) in host f64,
    as the collator computes it.  An f32 round on the device resolves
    near-.5 ties differently (30 * 0.15 is 4.50000018 in f32, rounded to
    5, and 4.4999999... in f64, rounded to 4)."""
    return torch.tensor([min(max_predictions, max(1, int(round(n * mlm_prob))))
                         for n in range(length + 1)], dtype=torch.int64)


def whole_word_selection(word_ids: torch.Tensor, special: torch.Tensor,
                         order_u: torch.Tensor, mlm_prob: float,
                         max_predictions: int = 512) -> torch.Tensor:
    """(B, L) bool: the whole-word selection of each row, its group order
    given by the uniforms ``order_u`` (B, L) (group g's key is
    ``order_u[:, g]``; absent groups sort last, ties by group id).

    word_ids: (B, L) int, -1 on special and padding; special: (B, L)
    bool.  The greedy-with-skip scan is a loop over the L positions of
    the sorted order on (B,) tensors."""
    B, L = word_ids.shape
    dev = word_ids.device
    wid = word_ids.long()
    valid = ~special & (wid >= 0)
    budget = budget_table(L, mlm_prob, max_predictions).to(dev)[
        valid.sum(dim=1)]                                    # B
    # group g's token count (0 where no token carries it)
    glen = torch.zeros(B, L, dtype=torch.int64, device=dev)
    glen.scatter_add_(1, wid.clamp(min=0), valid.long())
    u = torch.where(glen > 0, order_u.float(), order_u.new_tensor(2.0))
    order = torch.argsort(u, dim=1, stable=True)             # B,L group ids
    glen_sorted = glen.gather(1, order)
    covered = torch.zeros(B, dtype=torch.int64, device=dev)
    taken = torch.zeros(B, L, dtype=torch.bool, device=dev)
    for t in range(L):
        ln = glen_sorted[:, t]
        take = (ln > 0) & (covered + ln <= budget)
        covered = covered + torch.where(take, ln, 0)
        taken[:, t] = take
    selected = torch.zeros_like(taken).scatter_(1, order, taken)
    return selected.gather(1, wid.clamp(min=0)) & valid


def mlm_draws(shape, generator: torch.Generator, vocab_size: int,
              whole_word: bool) -> Dict[str, torch.Tensor]:
    """The randomness of ``apply_mlm`` for a (B, L) batch, drawn from
    ``generator`` (``rank_rand``: rank-invariant): the selection uniforms
    (the group order under whole-word masking), the replace and randomize
    uniforms, and the random tokens in [0, vocab_size)."""
    u = rank_rand((4,) + tuple(shape), generator, axis=1)
    tok = torch.clamp((u[3] * vocab_size).long(), max=vocab_size - 1)
    out = {"replace_u": u[1], "random_u": u[2], "random_tok": tok}
    out["order_u" if whole_word else "select_u"] = u[0]
    return out


def apply_mlm(ids: torch.Tensor, special: torch.Tensor,
              draws: Dict[str, torch.Tensor], mlm_prob: float,
              mask_token_id: int, word_ids: Optional[torch.Tensor] = None,
              max_predictions: int = 512):
    """Selection + 80/10/10 replacement + labels, given the draws
    (``mlm_draws``, or the JAX package's replayed).

    ids: (B, L) int; special: (B, L) bool (special OR padding); word_ids:
    (B, L) int for whole-word masking (``draws["order_u"]``), None for
    i.i.d. (``draws["select_u"]``).  Returns (mlm_ids, labels), labels
    IGNORE (-100) off the mask: the collator's mlm_input_ids and
    mlm_labels.  Each uniform is compared with its probability in f32."""
    def below(u, p):
        return u < u.new_tensor(p, dtype=torch.float32)

    if word_ids is None:
        masked = below(draws["select_u"], mlm_prob) & ~special
    else:
        masked = whole_word_selection(word_ids, special, draws["order_u"],
                                      mlm_prob, max_predictions)
    labels = torch.where(masked, ids, torch.full_like(ids, IGNORE))
    replaced = masked & below(draws["replace_u"], 0.8)
    randomized = masked & ~replaced & below(draws["random_u"], 0.5)
    mlm_ids = torch.where(
        replaced, torch.full_like(ids, mask_token_id),
        torch.where(randomized, draws["random_tok"].to(ids.dtype), ids))
    return mlm_ids, labels
