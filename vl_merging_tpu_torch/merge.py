"""Standalone merging CLI: checkpoint in → merged checkpoint out (port of
``vl_merging_tpu/merge.py``).

    python -m vl_merging_tpu_torch.merge with <named configs / overrides> \
        load_path=ms_model.ckpt merge_weights=True merge_ratio=0.5 \
        log_dir=out_dir

Writes ``{log_dir}/merged.ckpt`` (torch-readable, Lightning envelope).
The reference performs merging inline at model construction
(vilt_module.py:269-295); this tool exposes the same pipeline —
surgery → merge — without building a model, on the host
(``merging/core.py``: merged checkpoints equal the reference's bit for
bit).  ``regmean=True gram_matrices=G.pth`` takes the grams of
``train/gram.py``.
"""

from __future__ import annotations

import os
import sys

from .ckpt import io as ckpt_io
from .ckpt.pipeline import adapt_state_dict, apply_merging
from .config import parse_cli
from .models.spec import make_model_spec


def main(argv=None) -> str:
    cfg = parse_cli(argv if argv is not None else sys.argv[1:])
    if not cfg["load_path"]:
        raise SystemExit("load_path=<ckpt> is required")
    if not (cfg["merge_weights"] or cfg["sum_task_vectors"] or cfg["regmean"]):
        raise SystemExit("enable one of merge_weights / sum_task_vectors / "
                         "regmean")
    spec = make_model_spec(cfg)
    sd = ckpt_io.load_torch_checkpoint(cfg["load_path"])
    sd = adapt_state_dict(cfg, spec, sd, for_eval=True)
    merged = apply_merging(cfg, spec, sd)

    os.makedirs(cfg["log_dir"], exist_ok=True)
    out = os.path.join(cfg["log_dir"], "merged.ckpt")
    ckpt_io.save_torch_checkpoint(merged, out)
    print(f"wrote {out} ({len(merged)} tensors)")
    return out


if __name__ == "__main__":
    main()
