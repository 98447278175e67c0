"""Offline data prep: raw downloads → .arrow files.

Re-implements the reference's writer scripts (reference:
src/vilt/utils/write_{coco_karpathy,f30k_karpathy,vqa,nlvr2,sbu,vg,
conceptual_caption}.py) with identical output schemas, so arrows written
here are interchangeable with the reference's and vice versa.

Each function takes the raw-download root and the arrow output root.
"""

from __future__ import annotations

import json
import os
import random
from collections import Counter, defaultdict
from glob import glob
from typing import Dict, List, Optional

import pyarrow as pa

from .glossary import normalize_word


def _write_table(columns: Dict[str, list], path: str) -> None:
    table = pa.Table.from_arrays(
        [pa.array(v) for v in columns.values()], names=list(columns.keys()))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with pa.OSFile(path, "wb") as sink:
        with pa.RecordBatchFileWriter(sink, table.schema) as writer:
            writer.write_table(table)


def _read_binary(path: str) -> bytes:
    with open(path, "rb") as fp:
        return fp.read()


# --------------------------------------------------------------------------
# Karpathy-split caption datasets (coco / f30k)
# --------------------------------------------------------------------------

def make_arrow_coco_karpathy(root: str, dataset_root: str) -> None:
    """Schema: image, caption(list), image_id, split → one arrow per split
    (reference write_coco_karpathy.py)."""
    with open(f"{root}/karpathy/dataset_coco.json") as fp:
        images = json.load(fp)["images"]

    iid2captions = defaultdict(list)
    iid2split = {}
    for img in images:
        iid2split[img["filename"]] = img["split"]
        for s in img["sentences"]:
            iid2captions[img["filename"]].append(s["raw"])

    paths = glob(f"{root}/train2014/*.jpg") + glob(f"{root}/val2014/*.jpg")
    random.shuffle(paths)
    paths = [p for p in paths if os.path.basename(p) in iid2captions]

    rows = []
    for p in paths:
        name = os.path.basename(p)
        rows.append((_read_binary(p), iid2captions[name], name,
                     iid2split[name]))

    for split in ("train", "val", "restval", "test"):
        sel = [r for r in rows if r[3] == split]
        if not sel:
            continue
        _write_table(
            {"image": [r[0] for r in sel], "caption": [r[1] for r in sel],
             "image_id": [r[2] for r in sel], "split": [r[3] for r in sel]},
            f"{dataset_root}/coco_caption_karpathy_{split}.arrow")


def make_arrow_f30k_karpathy(root: str, dataset_root: str) -> None:
    """reference write_f30k_karpathy.py (images under flickr30k-images/)."""
    with open(f"{root}/karpathy/dataset_flickr30k.json") as fp:
        images = json.load(fp)["images"]

    iid2captions = defaultdict(list)
    iid2split = {}
    for img in images:
        iid2split[img["filename"]] = img["split"]
        for s in img["sentences"]:
            iid2captions[img["filename"]].append(s["raw"])

    paths = glob(f"{root}/flickr30k-images/*.jpg")
    paths = [p for p in paths if os.path.basename(p) in iid2captions]

    rows = [(_read_binary(p), iid2captions[os.path.basename(p)],
             os.path.basename(p), iid2split[os.path.basename(p)])
            for p in paths]
    for split in ("train", "val", "test"):
        sel = [r for r in rows if r[3] == split]
        if not sel:
            continue
        _write_table(
            {"image": [r[0] for r in sel], "caption": [r[1] for r in sel],
             "image_id": [r[2] for r in sel], "split": [r[3] for r in sel]},
            f"{dataset_root}/f30k_caption_karpathy_{split}.arrow")


# --------------------------------------------------------------------------
# Generic single-caption corpora (sbu, gcc, vg)
# --------------------------------------------------------------------------

def make_arrow_caption_shards(
    pairs: List[tuple], dataset_root: str, name: str,
    shard_size: Optional[int] = 256_000,
) -> None:
    """(image_path, caption) pairs → ``{name}_{shard}.arrow`` with the
    caption-list schema (reference write_sbu.py / write_conceptual_caption.py)."""
    shard_size = shard_size or len(pairs) or 1
    for shard_idx in range(0, max(1, (len(pairs) + shard_size - 1)
                                  // shard_size)):
        sel = pairs[shard_idx * shard_size:(shard_idx + 1) * shard_size]
        if not sel:
            continue
        _write_table(
            {"image": [_read_binary(p) for p, _ in sel],
             "caption": [[c] for _, c in sel]},
            f"{dataset_root}/{name}_{shard_idx}.arrow")


def make_arrow_vg(root: str, dataset_root: str) -> None:
    """Visual Genome region captions grouped per image
    (reference write_vg.py): one ``vg.arrow``."""
    with open(f"{root}/annotations/region_descriptions.json") as fp:
        regions = json.load(fp)

    iid2captions = defaultdict(list)
    for anns in regions:
        for r in anns["regions"]:
            iid2captions[r["image_id"]].append(r["phrase"])

    rows = []
    for iid, caps in iid2captions.items():
        for sub in ("VG_100K", "VG_100K_2"):
            p = f"{root}/images/{sub}/{iid}.jpg"
            if os.path.exists(p):
                rows.append((_read_binary(p), caps))
                break
    _write_table(
        {"image": [r[0] for r in rows], "caption": [r[1] for r in rows]},
        f"{dataset_root}/vg.arrow")


# --------------------------------------------------------------------------
# VQAv2
# --------------------------------------------------------------------------

def get_score(occurences: int) -> float:
    """Soft VQA score by answer count (reference write_vqa.py:13-23)."""
    if occurences == 0:
        return 0.0
    if occurences == 1:
        return 0.3
    if occurences == 2:
        return 0.6
    if occurences == 3:
        return 0.9
    return 1.0


def build_answer_vocab(annotation_files: List[str]) -> Dict[str, int]:
    """Answers normalized (VQA eval protocol) appearing ≥9 times
    (reference write_vqa.py:92-96)."""
    majors = []
    for path in annotation_files:
        with open(path) as fp:
            for q in json.load(fp)["annotations"]:
                majors.append(q["multiple_choice_answer"])
    majors = [normalize_word(w) for w in majors]
    counter = {k: v for k, v in Counter(majors).items() if v >= 9}
    return {k: i for i, k in enumerate(counter.keys())}


def make_arrow_vqa(root: str, dataset_root: str) -> None:
    """Full VQAv2 pipeline: answer vocab, soft labels, per-split arrows +
    trainable_val / rest_val split (reference write_vqa.py)."""
    q_files = {
        "train": "v2_OpenEnded_mscoco_train2014_questions.json",
        "val": "v2_OpenEnded_mscoco_val2014_questions.json",
        "test": "v2_OpenEnded_mscoco_test2015_questions.json",
        "test-dev": "v2_OpenEnded_mscoco_test-dev2015_questions.json",
    }
    a_files = {
        "train": "v2_mscoco_train2014_annotations.json",
        "val": "v2_mscoco_val2014_annotations.json",
    }

    annotations = {}
    for split, fn in q_files.items():
        with open(f"{root}/{fn}") as fp:
            qs = json.load(fp)["questions"]
        annot = defaultdict(dict)
        for q in qs:
            annot[q["image_id"]][q["question_id"]] = [q["question"]]
        annotations[split] = annot

    ans2label = build_answer_vocab(
        [f"{root}/{a_files['train']}", f"{root}/{a_files['val']}"])
    label2ans = list(ans2label.keys())

    for split in ("train", "val"):
        with open(f"{root}/{a_files[split]}") as fp:
            annots = json.load(fp)["annotations"]
        annot = annotations[split]
        for q in annots:
            counts: Dict[str, int] = {}
            for ans in q["answers"]:
                counts[ans["answer"]] = counts.get(ans["answer"], 0) + 1
            labels, scores = [], []
            for answer in counts:
                norm = normalize_word(answer)
                if norm not in ans2label:
                    continue
                labels.append(ans2label[norm])
                scores.append(get_score(counts[answer]))
            annot[q["image_id"]][q["question_id"]].append(
                {"labels": labels, "scores": scores})

    def rows_for(split: str, img_dir: str):
        rows = []
        for path in glob(f"{root}/{img_dir}/*.jpg"):
            iid = int(os.path.basename(path).split("_")[-1][:-4])
            if iid not in annotations[split]:
                continue
            items = list(annotations[split][iid].items())
            qids = [k for k, _ in items]
            questions = [v[0] for _, v in items]
            if "test" not in split:
                ans = [v[1] for _, v in items]
                answers = [[label2ans[l] for l in a["labels"]] for a in ans]
                labels = [a["labels"] for a in ans]
                scores = [a["scores"] for a in ans]
            else:
                answers, labels, scores = [], [], []
            rows.append((_read_binary(path), questions, answers, labels,
                         scores, iid, qids, split))
        return rows

    split_dirs = {"train": "train2014", "val": "val2014",
                  "test": "test2015", "test-dev": "test2015"}
    tables = {}
    for split, d in split_dirs.items():
        rows = rows_for(split, d)
        if rows:
            tables[split] = rows

    def write(rows, name):
        _write_table(
            {"image": [r[0] for r in rows],
             "questions": [r[1] for r in rows],
             "answers": [r[2] for r in rows],
             "answer_labels": [r[3] for r in rows],
             "answer_scores": [r[4] for r in rows],
             "image_id": [r[5] for r in rows],
             "question_id": [r[6] for r in rows],
             "split": [r[7] for r in rows]},
            f"{dataset_root}/{name}.arrow")

    if "train" in tables:
        write(tables["train"], "vqav2_train")
    if "val" in tables:
        val = tables["val"]
        random.seed(10)
        random.shuffle(val)
        write(val[:1000], "vqav2_rest_val")       # held-out val
        write(val[1000:], "vqav2_trainable_val")  # folded into training
    if "test" in tables:
        write(tables["test"], "vqav2_test")

    with open(f"{dataset_root}/vqav2_ans2label.json", "w") as fp:
        json.dump(ans2label, fp)


# --------------------------------------------------------------------------
# NLVR2
# --------------------------------------------------------------------------

def make_arrow_nlvr2(root: str, dataset_root: str) -> None:
    """Paired-image rows (reference write_nlvr2.py): train/dev/test1."""
    for split, json_name in (("train", "train.json"), ("dev", "dev.json"),
                             ("test1", "test1.json")):
        rows = []
        with open(f"{root}/nlvr2/data/{json_name}") as fp:
            data = [json.loads(l) for l in fp]
        for item in data:
            base = item["identifier"][: item["identifier"].rindex("-")]
            subdir = split if split != "test1" else "test1"
            p0 = f"{root}/images/{subdir}/{base}-img0.png"
            p1 = f"{root}/images/{subdir}/{base}-img1.png"
            if not (os.path.exists(p0) and os.path.exists(p1)):
                continue
            rows.append((_read_binary(p0), _read_binary(p1),
                         [item["sentence"]], [item["label"]],
                         [item["identifier"]]))
        if rows:
            _write_table(
                {"image_0": [r[0] for r in rows],
                 "image_1": [r[1] for r in rows],
                 "questions": [r[2] for r in rows],
                 "answers": [r[3] for r in rows],
                 "identifier": [r[4] for r in rows]},
                f"{dataset_root}/nlvr2_{split}.arrow")


# --------------------------------------------------------------------------
# ImageNet-1k (classification)
# --------------------------------------------------------------------------

def make_arrow_imagenet1k(root: str, dataset_root: str) -> None:
    """Class-per-directory layout → image bytes + integer label."""
    for split in ("train", "val"):
        classes = sorted(os.listdir(f"{root}/{split}"))
        rows = []
        for label, cls in enumerate(classes):
            for p in glob(f"{root}/{split}/{cls}/*"):
                rows.append((_read_binary(p), label))
        if rows:
            _write_table(
                {"image": [r[0] for r in rows],
                 "label": [r[1] for r in rows]},
                f"{dataset_root}/imagenet1k_{split}.arrow")
