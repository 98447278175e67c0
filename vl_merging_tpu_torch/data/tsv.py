"""TSV datasets: lineidx random access + base64 images.

Re-implements the reference's TSV stack (reference:
src/vilt/datasets/tsv_file.py:246-369, src/vilt/datasets/tsv_dataset.py:
50-511): a ``.tsv`` data file with a sibling ``.lineidx`` of byte offsets
for O(1) row seeks, optional composite indirection across shards, and an
image dataset whose rows carry base64-encoded JPEG bytes — the format the
reference uses for ImageNet-22k and web-scale corpora.
"""

from __future__ import annotations

import base64
import io
import json
import os
import os.path as op
from typing import Dict, List, Optional, Sequence

from PIL import Image

from .masking_generator import MaskingGenerator
from .transforms import keys_to_transforms, keys_to_transforms_for_mim


def generate_lineidx(tsv_path: str, lineidx_path: str) -> None:
    """Byte-offset index for each TSV row (written once, reused)."""
    offsets = []
    with open(tsv_path, "rb") as f:
        pos = 0
        for line in f:
            offsets.append(pos)
            pos += len(line)
    with open(lineidx_path, "w") as f:
        f.write("\n".join(str(o) for o in offsets))


class TSVFile:
    """Random-access TSV reader (reference tsv_file.py:246-312)."""

    def __init__(self, tsv_path: str, generate_index: bool = True):
        import threading

        self.tsv_path = tsv_path
        self.lineidx_path = op.splitext(tsv_path)[0] + ".lineidx"
        if not op.isfile(self.lineidx_path) and generate_index:
            generate_lineidx(tsv_path, self.lineidx_path)
        with open(self.lineidx_path) as f:
            self._offsets = [int(l) for l in f if l.strip()]
        # loader worker threads seek concurrently: one handle per thread
        self._local = threading.local()

    def num_rows(self) -> int:
        return len(self._offsets)

    def __len__(self) -> int:
        return self.num_rows()

    def seek(self, idx: int) -> List[str]:
        fh = getattr(self._local, "fh", None)
        if fh is None:
            fh = self._local.fh = open(self.tsv_path, "r")
        fh.seek(self._offsets[idx])
        return fh.readline().rstrip("\n").split("\t")

    def __getitem__(self, idx: int) -> List[str]:
        return self.seek(idx)


class CompositeTSVFile:
    """Row indirection over a list of shard TSVFiles
    (reference tsv_file.py:314-369): rows of the composite are
    (shard_idx, row_idx) pairs from a ``.lineidx`` composite listing."""

    def __init__(self, shard_paths: Sequence[str],
                 composite_rows: Optional[Sequence[tuple]] = None):
        self.shards = [TSVFile(p) for p in shard_paths]
        if composite_rows is None:
            composite_rows = [(s, r) for s, shard in enumerate(self.shards)
                              for r in range(len(shard))]
        self.rows = list(composite_rows)

    def __len__(self) -> int:
        return len(self.rows)

    def seek(self, idx: int) -> List[str]:
        s, r = self.rows[idx]
        return self.shards[s].seek(r)

    __getitem__ = seek


def decode_b64_image(data: str) -> Image.Image:
    raw = base64.b64decode(data)
    return Image.open(io.BytesIO(raw)).convert("RGB")


class TSVImageDataset:
    """Image(+label/caption) rows from TSV shards.

    Row format (reference imagenet_dataset.py / tsv_dataset.py):
    ``key \\t annotation \\t base64_image`` where annotation is either a
    JSON list of {"class": …} dicts, a plain label, or a caption string.
    Emits class-label text stubs for IN-22k-style pretraining
    (reference imagenet_dataset.py:394-411) or captions for web corpora.
    """

    def __init__(
        self,
        data_dir: str,
        names: List[str],
        transform_keys: List[str],
        image_size: int,
        patch_size: int = 16,
        num_mask_patches: int = 75,
        max_mask_patches_per_block: Optional[int] = None,
        min_mask_patches_per_block: int = 16,
        dvae_image_size: int = 112,
        max_text_len: int = 40,
        tokenizer=None,
        image_only: bool = True,
        caption_column: int = 1,
        image_column: int = 2,
        **_,
    ):
        paths = []
        for name in names:
            p = op.join(data_dir, f"{name}.tsv")
            if op.isfile(p):
                paths.append(p)
        if not paths:
            raise FileNotFoundError(f"no .tsv for {names} under {data_dir}")
        self.tsv = CompositeTSVFile(paths)
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self.image_only = image_only
        self.caption_column = caption_column
        self.image_column = image_column

        self.use_mim_transform = any(t.endswith("mim") for t in transform_keys)
        if self.use_mim_transform:
            window = image_size // patch_size
            self.masked_position_generator = MaskingGenerator(
                window, num_masking_patches=num_mask_patches,
                max_num_patches=max_mask_patches_per_block,
                min_num_patches=min_mask_patches_per_block)
            self.transforms = keys_to_transforms_for_mim(
                transform_keys, size=image_size, second_size=dvae_image_size)
        else:
            self.transforms = keys_to_transforms(transform_keys,
                                                 size=image_size)

    def __len__(self) -> int:
        return len(self.tsv)

    def _annotation_text(self, field: str) -> str:
        """JSON class annotations → 'a photo of <class>'-style text stub;
        plain strings pass through as captions."""
        try:
            parsed = json.loads(field)
        except (ValueError, TypeError):
            return field
        if isinstance(parsed, list) and parsed and isinstance(parsed[0], dict):
            cls = parsed[0].get("class", "")
            return str(cls).replace("_", " ")
        return str(parsed)

    def __getitem__(self, index: int) -> Dict:
        row = self.tsv[index]
        img = decode_b64_image(row[self.image_column])
        out = [tr(img) for tr in self.transforms]
        ret: Dict = {"img_index": index, "cap_index": None,
                     "raw_index": index}
        if self.use_mim_transform:
            views, targets = zip(*out)
            ret["image"] = views[0]
            ret["image_target"] = targets[0]
            ret["image_masked_pos"] = \
                self.masked_position_generator().reshape(-1)
        else:
            ret["image"] = out[0]
        if not self.image_only and self.tokenizer is not None:
            text = self._annotation_text(row[self.caption_column])
            ret["text"] = text
            ret["encoding"] = self.tokenizer.encode(
                text, max_length=self.max_text_len)
        return ret

    # share the arrow collate (numpy stacking + MLM keys)
    def collate(self, batch, mlm_collator):
        from .arrow_dataset import ArrowDataset

        return ArrowDataset.collate(self, batch, mlm_collator)

    @property
    def max_vl_text_len(self):
        return None

    @property
    def draw_false_text(self):
        return 0


def write_tsv(rows: List[List[str]], path: str) -> None:
    """Write rows + lineidx (data-prep helper, reference tsv_file.py)."""
    os.makedirs(op.dirname(op.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for row in rows:
            f.write("\t".join(row) + "\n")
    generate_lineidx(path, op.splitext(path)[0] + ".lineidx")


class SeqCompositeTSV:
    """Seq-file composite: global row i → shards[src].row (reference
    tsv_file.py:317-369).  ``file_list`` is a list of shard paths or a
    listing file with one path per line; the seq file's rows are
    ``src_idx \\t row_idx [\\t cap_idx]``."""

    def __init__(self, file_list, seq_file: str, root: str = "."):
        if isinstance(file_list, str):
            with open(op.join(root, file_list)) as f:
                file_list = [l.strip() for l in f if l.strip()]
        self.file_list = list(file_list)
        self.seq: List[tuple] = []
        with open(seq_file) as f:
            for line in f:
                parts = line.strip().split("\t")
                self.seq.append((int(parts[0]), int(parts[1])))
        self.tsvs = [TSVFile(op.join(root, p)) for p in self.file_list]

    def __len__(self) -> int:
        return len(self.seq)

    num_rows = __len__

    def seek(self, idx: int) -> List[str]:
        src, row = self.seq[idx]
        return self.tsvs[src].seek(row)

    __getitem__ = seek


def _find_in_yaml_dir(entry, root: str):
    if entry is None:
        return None
    path = entry if op.isabs(entry) else op.join(root, entry)
    return path


class TSVCompositeDataset:
    """YAML-driven composite TSV dataset (reference tsv_dataset.py:50-511).

    The yaml names a visual TSV and a caption TSV (single files, or shard
    lists with ``composite: true`` + a ``caption_linelist`` seq file whose
    rows are ``src \\t row \\t cap_idx``).  Caption rows are
    ``key \\t json`` where json is a list of ``{"caption": ...}`` dicts;
    visual rows carry base64 images in the last column (single-frame —
    the reference's temporal sampling collapses to the middle frame at
    ``size_frame=1``, which is what every shipped config uses).
    """

    def __init__(
        self,
        data_dir: str,
        transform_keys: List[str],
        image_size: int,
        split: str = "train",
        yaml_file: Optional[str] = None,
        patch_size: int = 16,
        num_mask_patches: int = 75,
        max_mask_patches_per_block: Optional[int] = None,
        min_mask_patches_per_block: int = 16,
        dvae_image_size: int = 112,
        max_text_len: int = 40,
        max_vl_text_len: Optional[int] = None,
        draw_false_image: int = 0,
        draw_false_text: int = 0,
        image_only: bool = False,
        tokenizer=None,
        **_,
    ):
        import yaml as _yaml

        if yaml_file is None:
            raise ValueError("TSVCompositeDataset needs yaml_file")
        if not op.isfile(yaml_file):
            yaml_file = op.join(data_dir, yaml_file)
        with open(yaml_file) as f:
            cfg = _yaml.safe_load(f)
        self.root = op.dirname(yaml_file)
        self.split = split
        self.is_composite = bool(cfg.get("composite", False))
        cap_linelist = _find_in_yaml_dir(cfg.get("caption_linelist"),
                                         self.root)

        def open_tsv(entry):
            if entry is None:
                return None
            if self.is_composite:
                return SeqCompositeTSV(entry, cap_linelist, root=self.root)
            return TSVFile(_find_in_yaml_dir(entry, self.root))

        self.visual_tsv = open_tsv(cfg.get("img"))
        self.cap_tsv = open_tsv(cfg.get("caption"))

        if self.is_composite:
            with open(cap_linelist) as f:
                self.cap_line_list = [int(l.strip().split("\t")[2])
                                      for l in f if l.strip()]
            self.img_line_list = list(range(len(self.cap_line_list)))
        elif cap_linelist:
            self.img_line_list, self.cap_line_list = [], []
            with open(cap_linelist) as f:
                for l in f:
                    a, b = (int(x) for x in l.strip().split("\t")[:2])
                    self.img_line_list.append(a)
                    self.cap_line_list.append(b)
        else:
            n = self.cap_tsv.num_rows() if self.cap_tsv is not None \
                else self.visual_tsv.num_rows()
            self.img_line_list = list(range(n))
            self.cap_line_list = [0] * n

        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self._max_vl_text_len = max_vl_text_len
        self._draw_false_text = draw_false_text
        self.image_only = image_only

        self.use_mim_transform = any(t.endswith("mim") for t in transform_keys)
        if self.use_mim_transform:
            window = image_size // patch_size
            self.masked_position_generator = MaskingGenerator(
                window, num_masking_patches=num_mask_patches,
                max_num_patches=max_mask_patches_per_block,
                min_num_patches=min_mask_patches_per_block)
            self.transforms = keys_to_transforms_for_mim(
                transform_keys, size=image_size, second_size=dvae_image_size)
        else:
            self.transforms = keys_to_transforms(transform_keys,
                                                 size=image_size)

    def __len__(self) -> int:
        return len(self.img_line_list)

    def _caption(self, img_idx: int, cap_idx: int) -> str:
        row = self.cap_tsv[img_idx]
        data = json.loads(row[1])
        sample = data[cap_idx]
        return sample.get("caption", "") if isinstance(sample, dict) \
            else str(sample)

    def __getitem__(self, index: int) -> Dict:
        img_idx = self.img_line_list[index]
        cap_idx = self.cap_line_list[index]
        row = self.visual_tsv[img_idx]
        img = decode_b64_image(row[-1])
        out = [tr(img) for tr in self.transforms]
        ret: Dict = {"img_index": img_idx, "cap_index": cap_idx,
                     "raw_index": index}
        if self.use_mim_transform:
            views, targets = zip(*out)
            ret["image"] = views[0]
            ret["image_target"] = targets[0]
            ret["image_masked_pos"] = \
                self.masked_position_generator().reshape(-1)
        else:
            ret["image"] = out[0]
        if not self.image_only and self.tokenizer is not None:
            text = self._caption(img_idx, cap_idx)
            ret["text"] = text
            ret["encoding"] = self.tokenizer.encode(
                text, max_length=self.max_text_len)
        return ret

    def collate(self, batch, mlm_collator):
        from .arrow_dataset import ArrowDataset

        return ArrowDataset.collate(self, batch, mlm_collator)

    @property
    def max_vl_text_len(self):
        return self._max_vl_text_len

    @property
    def draw_false_text(self):
        return self._draw_false_text


class CCSVWDataset(TSVCompositeDataset):
    """GoogleCC+COCO+SBU+VG+WebVid composite (reference
    combine_tsv_dataset.py:6-22) — yaml picked by split."""

    def __init__(self, data_dir, *args, split: str = "", **kwargs):
        yaml_file = (
            "train_cc3m-coco-sbu-vg-webvid2.5m_10.yaml" if split == "train"
            else "val_cc3m-coco-webvid2.5m.yaml")
        kwargs.pop("yaml_file", None)
        super().__init__(data_dir, *args, split=split,
                         yaml_file=op.join(data_dir, yaml_file), **kwargs)


class CCSVDataset(TSVCompositeDataset):
    """GoogleCC+COCO+SBU+VG composite (reference
    combine_tsv_dataset.py:25-37)."""

    def __init__(self, data_dir, *args, split: str = "", **kwargs):
        yaml_file = ("train_cc3m-coco-sbu-vg.yaml" if split == "train"
                     else "val_cc3m-coco.yaml")
        kwargs.pop("yaml_file", None)
        super().__init__(data_dir, *args, split=split,
                         yaml_file=op.join(data_dir, yaml_file), **kwargs)


class NewImageNetTSVDataset(TSVCompositeDataset):
    """IN-22k-as-captioned-TSV variant (reference new_imagenet_dataset.py:
    8-42 — vestigial there: never imported by a datamodule).

    The caption TSV's json rows are class annotations; the text fed to the
    model is the first annotation's ``class`` string, and ``class_label``
    is hard-set to 0 (reference :28 — the int label is parsed then
    overwritten; kept verbatim for parity)."""

    def __init__(self, data_dir, *args, split: str = "", **kwargs):
        yaml_file = ("train_imagenet-22k_30.yaml" if split == "train"
                     else "val_imagenet-22k.yaml")
        kwargs.pop("yaml_file", None)
        super().__init__(data_dir, *args, split=split,
                         yaml_file=op.join(data_dir, yaml_file), **kwargs)

    def _caption(self, img_idx: int, cap_idx: int) -> str:
        row = self.cap_tsv[img_idx]
        label = json.loads(row[1])
        return f"{label[0]['class']}"

    def __getitem__(self, index: int) -> Dict:
        ret = super().__getitem__(index)
        # the reference emits class_label only from get_text (:27-37 —
        # parses the int label, then overwrites it with 0); image_only
        # suites never see the key
        if not self.image_only and self.tokenizer is not None:
            ret["class_label"] = 0
        return ret
