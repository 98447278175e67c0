"""The port's own copy of the config module builds the same dicts as the
JAX package's, for every named config under every model mode."""

import pytest

from vl_merging_tpu import config as jconfig
from vl_merging_tpu_torch import config
from torch_port_threads import one_torch_thread  # noqa: F401

MODES = (None, "ufo", "ln_moe", "attn_moe", "ffn_moe", "all_moe")


def test_named_configs_and_tables_match_jax():
    assert config.named_config_names() == jconfig.named_config_names()
    assert config.LOSS_KEYS == jconfig.LOSS_KEYS
    assert config.VIT_PRESETS == jconfig.VIT_PRESETS
    assert config.base_config() == jconfig.base_config()


@pytest.mark.parametrize("mode", MODES)
def test_build_config_matches_jax(mode):
    for name in jconfig.named_config_names():
        names = (name,) + ((mode,) if mode else ())
        assert config.build_config(*names) == jconfig.build_config(*names), \
            names
    argv = ["with", "task_finetune_irtr_coco_square_randaug_base_image384",
            "step10k", "seed=3", "loss_names={'irtr': 1, 'itm': 1}"] + \
        ([mode] if mode else [])
    assert config.parse_cli(argv) == jconfig.parse_cli(argv)
    with pytest.raises(KeyError):
        config.build_config("no_such_config")
    with pytest.raises(ValueError):
        config.build_config("task_finetune_irtr_coco_square_randaug_base"
                            "_image384", overrides={"precision": "fp8"})
