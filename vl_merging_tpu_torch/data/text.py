"""Tokenization: offline WordPiece (BERT-compatible).

The reference builds a HF ``bert-base-uncased`` tokenizer at datamodule
setup (reference: src/vilt/datamodules/datamodule_base.py:13-22).  This
environment is zero-egress, so we construct the equivalent WordPiece
tokenizer directly from a local ``vocab.txt`` via the native `tokenizers`
library, falling back to `transformers` when its cache has the files.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List


class WordPieceTokenizer:
    """BERT-uncased-compatible WordPiece with fixed special tokens."""

    def __init__(self, vocab_file: str, lowercase: bool = True):
        from tokenizers import BertWordPieceTokenizer

        self._tok = BertWordPieceTokenizer(vocab_file, lowercase=lowercase)
        self.vocab: Dict[str, int] = self._tok.get_vocab()
        self.id_to_token = {v: k for k, v in self.vocab.items()}
        self.mask_token_id = self.vocab["[MASK]"]
        self.cls_token_id = self.vocab["[CLS]"]
        self.sep_token_id = self.vocab["[SEP]"]
        self.pad_token_id = self.vocab["[PAD]"]
        self.vocab_size = len(self.vocab)

    def encode(self, text: str, max_length: int) -> Dict[str, List[int]]:
        """Truncating encode with special tokens; unpadded lists
        (matches the reference's per-sample tokenizer call,
        base_dataset.py:156-162)."""
        self._tok.enable_truncation(max_length)
        enc = self._tok.encode(text)
        return {
            "input_ids": enc.ids,
            "attention_mask": enc.attention_mask,
            "special_tokens_mask": enc.special_tokens_mask,
            "tokens": enc.tokens,
        }

    def convert_ids_to_tokens(self, ids: List[int]) -> List[str]:
        return [self.id_to_token[i] for i in ids]


def build_tokenizer(name_or_path: str) -> WordPieceTokenizer:
    """vocab.txt file / directory containing one → offline WordPiece;
    otherwise try the transformers cache."""
    if os.path.isfile(name_or_path) and name_or_path.endswith("vocab.txt"):
        return WordPieceTokenizer(name_or_path)
    if os.path.isdir(name_or_path):
        vocab = os.path.join(name_or_path, "vocab.txt")
        if os.path.isfile(vocab):
            return WordPieceTokenizer(vocab)
    # fall back to transformers' cache (requires prior download)
    from transformers import BertTokenizerFast

    hf = BertTokenizerFast.from_pretrained(name_or_path)
    vocab_file = hf.vocab_files_names  # noqa: F841 — ensure tokenizer valid
    # the vocabulary goes to a fresh directory under $TMPDIR
    tmp = hf.save_vocabulary(tempfile.mkdtemp(prefix="vlm_tok_"))
    return WordPieceTokenizer(tmp[0])


def write_tiny_vocab(path: str, words: List[str]) -> str:
    """Test helper: minimal BERT-style vocab with special tokens, whole
    words, and '##' continuations."""
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    pieces: List[str] = []
    for w in words:
        w = w.lower()
        pieces.append(w)
        for i in range(1, len(w)):
            pieces.append("##" + w[i:])
    # single characters as last-resort subwords
    chars = sorted({c for w in words for c in w.lower()})
    pieces += chars + ["##" + c for c in chars]
    seen, vocab = set(), []
    for t in specials + pieces:
        if t not in seen:
            vocab.append(t)
            seen.add(t)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(vocab))
    return path
