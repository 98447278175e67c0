"""Video-frame datasets (MSRVTT-style): frame TSV + JSON annotations.

The reference's video stack (reference: src/vilt/datasets/
msrvtt_dataset.py:15-421, webvid_dataset.py:6-23) stores sampled video
frames in lineidx TSVs (rows: video_id \\t json \\t base64 frames…) with
caption annotations in JSON; current configs run single-frame
(num_frames=1), treating the sampled frame as an image.  This module
implements that single-frame contract: temporal sampling picks one frame
per clip (uniform index for eval, random for train).
"""

from __future__ import annotations

import json
import os.path as op
import random
from typing import Dict, List

from .masking_generator import MaskingGenerator, MaskingGenerator3D
from .tsv import CompositeTSVFile, TSVFile, decode_b64_image
from .transforms import keys_to_transforms, keys_to_transforms_for_mim


class FrameTSVDataset:
    """Frame rows: ``video_id \\t meta_json \\t b64_frame_0 [\\t b64_frame_k …]``.

    Captions come from ``{name}.caption.json``: {video_id: [captions…]} or
    the MSRVTT annotation list format [{"video_id","caption"}…].
    """

    def __init__(
        self,
        data_dir: str,
        names: List[str],
        transform_keys: List[str],
        image_size: int,
        max_text_len: int = 40,
        tokenizer=None,
        split: str = "train",
        size_frame: int = 1,
        patch_size: int = 16,
        num_mask_patches: int = 75,
        max_mask_patches_per_block=None,
        min_mask_patches_per_block: int = 16,
        dvae_image_size: int = 112,
        **_,
    ):
        paths = [op.join(data_dir, f"{n}.tsv") for n in names
                 if op.isfile(op.join(data_dir, f"{n}.tsv"))]
        if not paths:
            raise FileNotFoundError(f"no frame .tsv for {names} in {data_dir}")
        self.tsv = CompositeTSVFile(paths)
        # Video MIM (reference tsv_dataset.py:85-101): 2D block masks for
        # single-frame, MaskingGenerator3D over (T, H, W) slabs with
        # num_mask_patches scaled by the frame count otherwise.
        self.use_mim_transform = any(t.endswith("mim") for t in transform_keys)
        if self.use_mim_transform:
            window = image_size // patch_size
            if size_frame == 1:
                self.masked_position_generator = MaskingGenerator(
                    window, num_masking_patches=num_mask_patches,
                    max_num_patches=max_mask_patches_per_block,
                    min_num_patches=min_mask_patches_per_block)
            else:
                self.masked_position_generator = MaskingGenerator3D(
                    window, size_frame,
                    num_masking_patches=num_mask_patches * size_frame,
                    max_num_patches=max_mask_patches_per_block,
                    min_num_patches=min_mask_patches_per_block)
            self.transforms = keys_to_transforms_for_mim(
                transform_keys, size=image_size, second_size=dvae_image_size)
        else:
            self.transforms = keys_to_transforms(transform_keys,
                                                 size=image_size)
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self.split = split
        self.size_frame = size_frame

        self.captions = self._load_captions(data_dir, names)

        # caption-flattened index like the arrow datasets' index_mapper
        self.index_mapper: Dict[int, tuple] = {}
        j = 0
        for row_idx in range(len(self.tsv)):
            vid = self.tsv[row_idx][0]
            caps = self.captions.get(vid, [None])
            for ci in range(len(caps)):
                self.index_mapper[j] = (row_idx, ci)
                j += 1

    def _load_captions(self, data_dir: str,
                       names: List[str]) -> Dict[str, List[str]]:
        captions: Dict[str, List[str]] = {}
        for n in names:
            cpath = op.join(data_dir, f"{n}.caption.json")
            if not op.isfile(cpath):
                continue
            with open(cpath) as f:
                data = json.load(f)
            if isinstance(data, dict):
                for vid, caps in data.items():
                    captions.setdefault(vid, []).extend(
                        caps if isinstance(caps, list) else [caps])
            else:
                for item in data:
                    captions.setdefault(item["video_id"], []).append(
                        item["caption"])
        return captions

    def _img_index(self, row_idx: int, vid: str) -> int:
        """Retrieval-grouping id for a row; subclasses may parse ``vid``."""
        return row_idx

    def __len__(self) -> int:
        return len(self.index_mapper)

    @staticmethod
    def _sampling(start: int, end: int, n: int) -> List[int]:
        """Evenly spaced indices incl. endpoints; n=1 → midpoint
        (reference msrvtt_dataset.py:122-128)."""
        if n == 1:
            return [int(round((start + end) / 2.0))]
        step = (end - start) / float(n - 1)
        return [int(round(start + x * step)) for x in range(n)]

    def temporal_sample(self, n_avail: int, *, random_sample: bool,
                        center_frame: bool) -> List[int]:
        """Pick ``size_frame`` frame indices out of ``n_avail``
        (reference msrvtt_dataset.py:130-155): eval single-frame takes the
        middle frame; train picks a random clip start and samples evenly
        to the clip-strided end; multi-frame eval spans the whole clip."""
        if n_avail == 1 or self.size_frame == n_avail:
            return list(range(n_avail))
        size_frame = min(self.size_frame, n_avail)
        size_clips = -(-n_avail // size_frame)  # ceil
        if center_frame:
            start = end = n_avail // 2
        elif random_sample:
            start = random.choice(range(size_clips))
            end = min(start + (size_frame - 1) * size_clips, n_avail - 1)
        else:
            start = 0
            end = n_avail - 1
        return self._sampling(start, end, size_frame)

    def _sample_frames(self, row: List[str]) -> List[int]:
        n_frames = max(len(row) - 2, 1)
        random_sample = self.split == "train"
        idx = self.temporal_sample(
            n_frames, random_sample=random_sample,
            center_frame=(not random_sample and self.size_frame == 1))
        return [2 + i for i in idx]

    @staticmethod
    def _stack_or_single(frames):
        if len(frames) == 1:
            return frames[0]
        import numpy as _np
        return _np.stack(frames, axis=0)

    def __getitem__(self, index: int) -> Dict:
        row_idx, cap_idx = self.index_mapper[index]
        row = self.tsv[row_idx]
        frames = [self.transforms[0](decode_b64_image(row[i]))
                  for i in self._sample_frames(row)]
        ret: Dict = {
            "img_index": self._img_index(row_idx, row[0]),
            "cap_index": cap_idx,
            "raw_index": index,
        }
        # single-frame (all reference configs: num_frames=1) keeps the image
        # contract; multi-frame stacks (T, C, H, W) like the reference's
        # torch.stack(image_tensor, dim=0) (msrvtt_dataset.py:200-210)
        if self.use_mim_transform:
            views, targets = zip(*frames)
            ret["image"] = self._stack_or_single(list(views))
            ret["image_target"] = self._stack_or_single(list(targets))
            ret["image_masked_pos"] = \
                self.masked_position_generator().reshape(-1)
        else:
            ret["image"] = self._stack_or_single(frames)
        caps = self.captions.get(row[0])
        if caps and self.tokenizer is not None:
            text = caps[cap_idx]
            ret["text"] = text
            ret["encoding"] = self.tokenizer.encode(
                text, max_length=self.max_text_len)
        return ret

    def collate(self, batch, mlm_collator):
        from .arrow_dataset import ArrowDataset

        return ArrowDataset.collate(self, batch, mlm_collator)

    @property
    def max_vl_text_len(self):
        return None

    @property
    def draw_false_text(self):
        return 0


class MSRVTTDataset(FrameTSVDataset):
    """reference msrvtt_dataset.py: frame TSVs named per split."""

    def __init__(self, *args, split: str = "train", **kwargs):
        names = kwargs.pop("names", None) or [f"msrvtt_{split}"]
        kwargs.pop("draw_false_image", None)
        kwargs.pop("draw_false_text", None)
        kwargs.pop("image_only", None)
        kwargs.pop("max_vl_text_len", None)
        super().__init__(*args, names=names, split=split, **kwargs)


class WebVidDataset(MSRVTTDataset):
    """reference webvid_dataset.py: same frame-TSV contract."""

    def __init__(self, *args, split: str = "train", **kwargs):
        kwargs["names"] = [f"webvid_{split}"]
        super().__init__(*args, split=split, **kwargs)


class DidemoDataset(MSRVTTDataset):
    """DiDeMo retrieval (reference didemo_dataset.py:6-40, vestigial — no
    registry entry in the reference): ONE shared frame TSV
    (``img_didemo.tsv``) serves every split; captions come from
    ``txt_didemo-retrieval.json`` as ``[{"video", "caption": [..]}]`` and
    are flattened one-per-caption (didemo_dataset.py:19-27); video ids
    carry an ``@``-suffix that is stripped to an int for retrieval
    grouping (``get_video_id``, didemo_dataset.py:36-40)."""

    def __init__(self, *args, split: str = "train", **kwargs):
        kwargs["names"] = ["img_didemo"]
        super().__init__(*args, split=split, **kwargs)

    def _load_captions(self, data_dir, names):
        cpath = op.join(data_dir, "txt_didemo-retrieval.json")
        captions: Dict[str, List[str]] = {}
        if op.isfile(cpath):
            with open(cpath) as f:
                for item in json.load(f):
                    caps = item["caption"]
                    captions.setdefault(item["video"], []).extend(
                        caps if isinstance(caps, list) else [caps])
        return captions

    def _img_index(self, row_idx: int, vid: str) -> int:
        return int(vid.split("@")[0])
