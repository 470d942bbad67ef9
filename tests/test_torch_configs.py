"""The run configs this port added for the Visualizer, the test paths and
the bird (`test_fauna`, `test_ponymation_*`, `test_magicpony_*`,
`train_magicpony_bird`, `finetune_magicpony_*`): each composes to the JAX
package's dict of the same name, but for the two keys the port's
`base.yaml` names with the trainer's defaults (`checkpoint_path` null,
`load_optim` true) where the run file sets neither."""
import pytest

from animals3d_tpu import config as jcfg
from animals3d_tpu_torch import config as tcfg
from animals3d_tpu_torch.trainer import TrainerConfig

NEW_CONFIGS = ["test_fauna", "train_magicpony_bird"] + \
    [f"test_ponymation_{a}" for a in ("horse", "cow", "giraffe", "zebra")] + \
    [f"test_magicpony_{a}" for a in ("bird", "cow", "giraffe", "zebra")] + \
    [f"finetune_magicpony_{a}" for a in ("cow", "giraffe", "zebra")]


@pytest.mark.parametrize("name", NEW_CONFIGS)
def test_config_composes_as_in_jax(name):
    got, want = tcfg.load_config(name), jcfg.load_config(name)
    for k in ("checkpoint_path", "load_optim"):
        if k not in want:
            assert got.pop(k) == getattr(TrainerConfig, k), k
    assert got == want
