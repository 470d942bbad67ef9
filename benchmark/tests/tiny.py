"""Tiny cells for the CPU tests: the configurations' own port configs with
small widths, so that a run's set-up, window and check take seconds."""
from harness import spec

TINY = [
    "dataset.in_image_size=64", "dataset.out_image_size=64",
    "model.cfg_predictor_base.cfg_shape.grid_res=8",
    "model.cfg_predictor_base.cfg_shape.grid_res_coarse=8",
    "model.cfg_predictor_base.cfg_shape.num_layers=2",
    "model.cfg_predictor_base.cfg_dino.num_layers=2",
    "model.cfg_predictor_base.cfg_dino.hidden_size=32",
    "model.cfg_predictor_base.cfg_dino.feature_dim=4",
    "model.cfg_predictor_instance.cfg_encoder.cout=32",
    "model.cfg_predictor_instance.cfg_texture.num_layers=2",
    "model.cfg_predictor_instance.cfg_texture.hidden_size=32",
    "model.cfg_predictor_instance.cfg_deform.num_layers=2",
    "model.cfg_predictor_instance.cfg_deform.hidden_size=32",
    "model.cfg_predictor_instance.cfg_articulation.num_layers=1",
    "model.cfg_predictor_instance.cfg_articulation.hidden_size=32",
    "model.cfg_predictor_instance.cfg_light.num_layers=2",
    "model.cfg_predictor_instance.cfg_light.hidden_size=32",
    "dataset.dino_feature_dim=4",
]
# netSDF at its 256 width, so that training takes the fused sweep
SWEEP = ["model.cfg_predictor_base.cfg_shape.hidden_size=256"]
NARROW = ["model.cfg_predictor_base.cfg_shape.hidden_size=32"]
FAUNA = NARROW + ["model.cfg_predictor_base.cfg_bank.memory_bank_size=14",
                  "+model.cfg_predictor_base.cfg_bank.memory_bank_topk=3"]


def cell(workload: str, limits=None, extra=None) -> spec.Cell:
    """The benchmark's cell `workload` at the tiny size: its own files,
    with the tiny overrides, a pool of 3 batches of 2 and 2 steps."""
    c = spec.load_cell(workload)
    w = dict(c.workload)
    name = c.config["name"]
    if extra is None:
        extra = {"fauna": FAUNA}.get(name, SWEEP if w["entry"] == "train"
                                     else NARROW)
    w.update(batch=2, pool=3, ref_steps=2, log_loss_freq=2, trace_steps=1,
             sample=1, warmup=1,
             overrides=list(w.get("overrides", [])) + TINY + list(extra))
    if limits is not None:
        w["limits"] = limits
    return spec.Cell(c.name, w, c.config, 1, c.end_to_end, c.per_layer)
