"""Checkpoint conversion CLI: reference ckpt → adapted native checkpoint
(port of ``vl_merging_tpu/convert.py``).

    python -m vl_merging_tpu_torch.convert with <named configs / overrides> \
        load_path=beit.ckpt use_beit_weight=True log_dir=out

Runs the flavor-appropriate surgery (vlmo / beit / self,
ckpt/surgery.py) against the target architecture and writes
``{log_dir}/converted.ckpt`` plus a key report (missing/unexpected vs the
model schema).  Useful for preparing fine-tune inits offline instead of
at trainer start.
"""

from __future__ import annotations

import os
import sys

from .ckpt import io as ckpt_io
from .ckpt.pipeline import adapt_state_dict
from .config import parse_cli
from .models.spec import make_model_spec


def main(argv=None) -> str:
    cfg = parse_cli(argv if argv is not None else sys.argv[1:])
    if not cfg["load_path"]:
        raise SystemExit("load_path=<ckpt> is required")
    spec = make_model_spec(cfg)
    sd = ckpt_io.load_torch_checkpoint(cfg["load_path"])
    sd = adapt_state_dict(cfg, spec, sd)
    _, missing, unexpected = ckpt_io.state_dict_to_params(sd, spec)

    os.makedirs(cfg["log_dir"], exist_ok=True)
    out = os.path.join(cfg["log_dir"], "converted.ckpt")
    ckpt_io.save_torch_checkpoint(sd, out)
    print(f"wrote {out} ({len(sd)} tensors)")
    if missing:
        print(f"missing vs model schema ({len(missing)}): {missing[:10]}…")
    if unexpected:
        print(f"unexpected ({len(unexpected)}): {unexpected[:10]}…")
    return out


if __name__ == "__main__":
    main()
