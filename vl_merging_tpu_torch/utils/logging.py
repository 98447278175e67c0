"""Small runtime utilities: seeding, config printing."""

from __future__ import annotations

import random

import numpy as np


def seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)


def print_config(cfg: dict) -> None:
    import json

    def default(o):
        return str(o)

    print(json.dumps(cfg, indent=2, default=default))
