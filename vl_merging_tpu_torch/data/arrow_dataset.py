"""Arrow-backed datasets: same .arrow files, fixed-shape batches.

Reads the exact ``{name}.arrow`` files the reference produces
(reference: src/vilt/datasets/base_dataset.py:69-106 and
src/vilt/utils/write_*.py), flattens image→captions through an
index_mapper, decodes JPEG bytes with PIL, applies the transform registry,
and collates into fixed-shape NumPy batches ready for the device
(``train/loop.device_feed``).

Differences from the reference, by design:
  * collate returns plain numpy arrays (static shapes, images stacked
    NCHW float32) rather than torch tensors,
  * the per-sample corrupt-image retry (base_dataset.py:183-202) is kept,
    but deterministic (index + attempt seeded) for reproducible epochs.
"""

from __future__ import annotations

import io
import os
import random
from typing import Dict, List, Optional

import numpy as np
import pyarrow as pa
from PIL import Image

from .collators import MLMCollator
from .masking_generator import MaskingGenerator
from .transforms import keys_to_transforms, keys_to_transforms_for_mim


class ArrowDataset:
    def __init__(
        self,
        data_dir: str,
        transform_keys: List[str],
        image_size: int,
        names: List[str],
        patch_size: int = 16,
        num_mask_patches: int = 75,
        max_mask_patches_per_block: Optional[int] = None,
        min_mask_patches_per_block: int = 16,
        dvae_image_size: int = 112,
        text_column_name: str = "",
        remove_duplicate: bool = True,
        max_text_len: int = 40,
        max_vl_text_len: Optional[int] = None,
        draw_false_image: int = 0,
        draw_false_text: int = 0,
        image_only: bool = False,
        tokenizer=None,
        size_frame: int = 1,  # video-only knob; ignored for arrow images
        device_augment: bool = False,
        canvas_size: int = 640,
    ):
        self.data_dir = data_dir
        self.names = names
        self.text_column_name = text_column_name
        self.max_text_len = max_text_len
        self.max_vl_text_len = max_vl_text_len
        self.draw_false_image = draw_false_image
        self.draw_false_text = draw_false_text
        self.image_only = image_only
        self.tokenizer = tokenizer

        self.use_mim_transform = any(t.endswith("mim") for t in transform_keys)
        # device_augment: skip host transforms entirely — emit native-size
        # uint8; crop/flip/randaug/normalize run in-graph
        # (ops/augment.augment_train_batch, wired by the train step)
        self.device_augment = device_augment
        self.canvas_size = canvas_size
        if device_augment:
            if self.use_mim_transform:
                raise ValueError("device_augment does not support the "
                                 "two-view MIM transforms")
            if draw_false_image:
                raise ValueError("device_augment is incompatible with "
                                 "draw_false_image (the SPMD objectives "
                                 "draw negatives from the global batch)")
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

        tables = [
            pa.ipc.RecordBatchFileReader(
                pa.memory_map(os.path.join(data_dir, f"{name}.arrow"), "r")
            ).read_all()
            for name in names
            if os.path.isfile(os.path.join(data_dir, f"{name}.arrow"))
        ]
        if not tables:
            raise FileNotFoundError(
                f"no .arrow files for {names} under {data_dir}")
        self.table_names: List[str] = []
        for i, name in enumerate(names):
            if i < len(tables):
                self.table_names += [name] * len(tables[i])
        self.table = pa.concat_tables(tables, promote_options="permissive")

        if text_column_name:
            texts = self.table[text_column_name].to_pylist()
            self.all_texts = ([list(dict.fromkeys(t)) for t in texts]
                              if remove_duplicate else texts)
        else:
            self.all_texts = []

        self.index_mapper: Dict[int, tuple] = {}
        if text_column_name and not image_only:
            j = 0
            for i, texts in enumerate(self.all_texts):
                for jj in range(len(texts)):
                    self.index_mapper[j] = (i, jj)
                    j += 1
        else:
            for i in range(len(self.table)):
                self.index_mapper[i] = (i, None)

    def __len__(self) -> int:
        return len(self.index_mapper)

    @property
    def corpus(self):
        return [t for texts in self.all_texts for t in texts]

    # -- raw access --------------------------------------------------------
    def get_raw_image(self, index: int, image_key: str = "image"):
        row, _ = self.index_mapper[index]
        data = self.table[image_key][row].as_py()
        img = Image.open(io.BytesIO(data))
        return img.convert("RGB")

    def get_image(self, index: int, image_key: str = "image") -> Dict:
        row, cap = self.index_mapper[index]
        if self.device_augment:
            img = self.get_raw_image(index, image_key=image_key)
            cs = self.canvas_size
            # Images LARGER than the canvas are pre-downscaled with PIL
            # here, so the in-graph RandomResizedCrop then samples and
            # resamples from a cs-max image rather than the native one —
            # a deliberate double-resample deviation from the host train
            # path for oversized images (the crop-BOX distribution is
            # near scale-invariant; the pixels are not).  Documented per
            # ADVICE r4 #4; images at or under canvas_size ride the link
            # native and match the host path's sampling base exactly.
            if max(img.size) > cs:  # fit-to-canvas, aspect kept
                w, h = img.size
                s = cs / max(w, h)
                img = img.resize((max(1, round(w * s)),
                                  max(1, round(h * s))), Image.BICUBIC)
            return {"img_index": row, "cap_index": cap, "raw_index": index,
                    "image_raw": np.asarray(img, np.uint8)}
        # fused native decode path for the deterministic eval transform
        tr0 = self.transforms[0]
        if len(self.transforms) == 1 and hasattr(tr0, "transform_bytes"):
            fast = tr0.transform_bytes(self.table[image_key][row].as_py())
            if fast is not None:
                ret = {"img_index": row, "cap_index": cap,
                       "raw_index": index, image_key: fast}
                return ret
        image = self.get_raw_image(index, image_key=image_key)
        out = [tr(image) for tr in self.transforms]
        ret = {"img_index": row, "cap_index": cap, "raw_index": index}
        if self.use_mim_transform:
            views, targets = zip(*out)
            ret["image_target"] = targets[0]
            ret["image_masked_pos"] = \
                self.masked_position_generator().reshape(-1)
            ret[image_key] = views[0]
        else:
            ret[image_key] = out[0]
        return ret

    def get_false_image(self, rep: int, rng: random.Random,
                        image_key: str = "image") -> Dict:
        idx = rng.randint(0, len(self.index_mapper) - 1)
        image = self.get_raw_image(idx, image_key=image_key)
        out = self.transforms[0](image)
        if self.use_mim_transform:
            out = out[0]
        return {f"false_image_{rep}": out}

    def get_text(self, raw_index: int) -> Dict:
        row, cap = self.index_mapper[raw_index]
        text = self.all_texts[row][cap]
        max_len = (self.max_text_len if self.max_vl_text_len is None
                   else self.max_vl_text_len)
        enc = self.tokenizer.encode(text, max_length=max_len)
        return {"text": text, "encoding": enc, "img_index": row,
                "cap_index": cap, "raw_index": raw_index}

    def get_false_text(self, rep: int, rng: random.Random) -> Dict:
        idx = rng.randint(0, len(self.index_mapper) - 1)
        row, cap = self.index_mapper[idx]
        text = self.all_texts[row][cap]
        max_len = (self.max_text_len if self.max_vl_text_len is None
                   else self.max_vl_text_len)
        return {f"false_text_{rep}":
                {"text": text,
                 "encoding": self.tokenizer.encode(text, max_length=max_len)}}

    def get_suite(self, index: int) -> Dict:
        """Sample with deterministic corrupt-file retry."""
        for attempt in range(32):
            rng = random.Random(hash((index, attempt)) & 0xFFFFFFFF)
            try:
                ret = dict(self.get_image(index))
                if not self.image_only:
                    txt = self.get_text(index)
                    ret["replica"] = bool(txt["cap_index"])
                    ret.update(txt)
                for i in range(self.draw_false_image):
                    ret.update(self.get_false_image(i, rng))
                for i in range(self.draw_false_text):
                    ret.update(self.get_false_text(i, rng))
                return ret
            except Exception as e:  # corrupt sample: deterministic re-draw
                print(f"Error reading idx {index} in {self.names[0]} -> {e}")
                index = rng.randint(0, len(self.index_mapper) - 1)
        raise RuntimeError("too many corrupt samples")

    def __getitem__(self, index: int) -> Dict:
        return self.get_suite(index)

    # -- collation ---------------------------------------------------------
    def collate(self, batch: List[Dict],
                mlm_collator: MLMCollator) -> Dict[str, np.ndarray]:
        """Stack images, pad/mask text (reference base_dataset.py:204-253).

        Emits, per text key: {key}_ids, {key}_labels (all −100),
        {key}_ids_mlm, {key}_labels_mlm, {key}_masks."""
        keys = {k for b in batch for k in b}
        out: Dict[str, np.ndarray] = {}

        max_len = (self.max_text_len if self.max_vl_text_len is None
                   else self.max_vl_text_len)

        if "image_raw" in keys:
            # device_augment: zero-padded uint8 canvas + native sizes; the
            # train step compiles crop/flip/randaug/normalize in-graph
            cs = self.canvas_size
            raws = [b["image_raw"] for b in batch]
            canvas = np.zeros((len(raws), cs, cs, 3), np.uint8)
            sizes = np.zeros((len(raws), 2), np.int32)
            for i, r in enumerate(raws):
                h, w = r.shape[:2]
                canvas[i, :h, :w] = r
                sizes[i] = (h, w)
            out["image_canvas"] = canvas
            out["image_sizes"] = sizes

        for k in keys:
            vals = [b.get(k) for b in batch]
            if k in ("encoding", "text", "replica", "image_raw") or \
                    k.startswith("false_text"):
                continue
            if k == "image_masked_pos":
                out[k] = np.stack(vals).astype(np.int32)
            elif all(isinstance(v, np.ndarray) for v in vals) and \
                    len({v.shape for v in vals}) == 1:
                out[k] = np.stack(vals)
            elif all(isinstance(v, (int, float, bool, np.integer,
                                    np.floating)) for v in vals):
                out[k] = np.asarray(vals)
            else:
                out[k] = vals  # ragged / python payloads (qid, answers, ...)

        if "encoding" in keys and self.tokenizer is not None:
            text_groups = {"text": [b["encoding"] for b in batch]}
            for i in range(self.draw_false_text):
                text_groups[f"false_text_{i}"] = [
                    b[f"false_text_{i}"]["encoding"] for b in batch]
            for name, encodings in text_groups.items():
                m = mlm_collator(encodings, max_length=max_len)
                out[f"{name}_ids"] = m["input_ids"]
                out[f"{name}_labels"] = np.full_like(m["input_ids"], -100)
                if "word_ids" in m:
                    # device_mlm mode: masking happens in-graph
                    # (train_step._device_mlm_batch); false texts never
                    # consume mlm keys, so only "text" carries word ids
                    if name == "text":
                        out["text_word_ids"] = m["word_ids"]
                else:
                    out[f"{name}_ids_mlm"] = m["mlm_input_ids"]
                    out[f"{name}_labels_mlm"] = m["mlm_labels"]
                out[f"{name}_masks"] = m["attention_mask"]
            out["text"] = [b["text"] for b in batch]
        return out
