"""MLM collators: standard and whole-word masking, NumPy-native.

Distribution-equivalent re-implementation of HF's
DataCollatorForLanguageModeling / DataCollatorForWholeWordMask, which the
reference selects per-datamodule (reference:
src/vilt/datamodules/datamodule_base.py:64-72) and invokes inside dataset
collate (reference: src/vilt/datasets/base_dataset.py:223).

Semantics:
  * candidate positions = non-special, non-padding tokens,
  * standard: each candidate masked i.i.d. with p = mlm_prob,
  * whole-word: '##'-continuation tokens group with their word; whole words
    are sampled (shuffled) until round(len * mlm_prob) tokens are covered,
  * replacement: 80% [MASK], 10% random token, 10% unchanged,
  * labels = original ids at masked positions, −100 elsewhere.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

IGNORE = -100


class MLMCollator:
    def __init__(self, tokenizer, mlm_prob: float = 0.15,
                 whole_word: bool = False,
                 seed: int | None = None,
                 max_predictions: int = 512,
                 device: bool = False):
        self.tokenizer = tokenizer
        self.mlm_prob = mlm_prob
        self.whole_word = whole_word
        self.max_predictions = max_predictions
        self.device = device  # emit word ids; masking happens in-graph
        self.rng = np.random.default_rng(seed)

    # -- whole-word candidate grouping (HF _whole_word_mask) ---------------
    def _word_groups(self, tokens: List[str],
                     special: List[int]) -> List[List[int]]:
        groups: List[List[int]] = []
        for i, (tok, sp) in enumerate(zip(tokens, special)):
            if sp:
                continue
            if groups and tok.startswith("##"):
                groups[-1].append(i)
            else:
                groups.append([i])
        return groups

    def _wwm_mask(self, tokens: List[str], special: List[int]) -> np.ndarray:
        groups = self._word_groups(tokens, special)
        self.rng.shuffle(groups)
        n_candidates = sum(len(g) for g in groups)
        num_to_predict = min(self.max_predictions,
                             max(1, int(round(n_candidates * self.mlm_prob))))
        mask = np.zeros(len(tokens), dtype=bool)
        covered = 0
        for g in groups:
            if covered >= num_to_predict:
                break
            if covered + len(g) > num_to_predict:
                continue
            mask[g] = True
            covered += len(g)
        return mask

    def __call__(self, encodings: List[Dict], max_length: int) -> Dict:
        """Pads to max_length and applies masking.

        Returns input_ids, labels, attention_mask, and the clean ids —
        everything the reference collate emits per text key
        (base_dataset.py:236-251)."""
        bsz = len(encodings)
        ids = np.full((bsz, max_length), self.tokenizer.pad_token_id,
                      dtype=np.int64)
        attn = np.zeros((bsz, max_length), dtype=np.int64)
        special = np.ones((bsz, max_length), dtype=bool)
        masked = np.zeros((bsz, max_length), dtype=bool)

        if self.device:
            # in-graph masking mode (ops/text_masking.py): emit the
            # RNG-free word-boundary map instead of consuming host RNG;
            # -1 marks special/padding positions
            word_ids = np.full((bsz, max_length), -1, dtype=np.int32)
            for i, enc in enumerate(encodings):
                L = len(enc["input_ids"])
                ids[i, :L] = enc["input_ids"]
                attn[i, :L] = enc["attention_mask"]
                tokens = enc.get("tokens") or \
                    self.tokenizer.convert_ids_to_tokens(enc["input_ids"])
                groups = self._word_groups(tokens,
                                           enc["special_tokens_mask"])
                for g_idx, g in enumerate(groups):
                    word_ids[i, g] = g_idx
            return {
                "input_ids": ids,
                "attention_mask": attn,
                "word_ids": word_ids,
            }

        for i, enc in enumerate(encodings):
            L = len(enc["input_ids"])
            ids[i, :L] = enc["input_ids"]
            attn[i, :L] = enc["attention_mask"]
            special[i, :L] = np.asarray(enc["special_tokens_mask"],
                                        dtype=bool)
            if self.whole_word:
                tokens = enc.get("tokens") or \
                    self.tokenizer.convert_ids_to_tokens(enc["input_ids"])
                masked[i, :L] = self._wwm_mask(tokens,
                                               enc["special_tokens_mask"])

        if not self.whole_word:
            probs = np.where(special, 0.0, self.mlm_prob)
            masked = self.rng.random(ids.shape) < probs
        else:
            masked &= ~special

        labels = np.where(masked, ids, IGNORE)

        mlm_ids = ids.copy()
        replaced = masked & (self.rng.random(ids.shape) < 0.8)
        mlm_ids[replaced] = self.tokenizer.mask_token_id
        randomized = masked & ~replaced & (self.rng.random(ids.shape) < 0.5)
        mlm_ids[randomized] = self.rng.integers(
            0, self.tokenizer.vocab_size, size=int(randomized.sum()))

        return {
            "input_ids": ids,
            "attention_mask": attn,
            "mlm_input_ids": mlm_ids,
            "mlm_labels": labels,
        }
