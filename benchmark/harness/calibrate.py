"""Readings for setting a cell's limits: the comparison's numbers over
many seeds in one process, for the program, the control (the reference
in float8 in the program's place) and the planted faults.

    python3 benchmark/harness/calibrate.py --workload <cell> \
        --what program,control,halfbatch --seeds 1,2,3 [--seconds 2]

Prints one JSON line per (what, seed) with its readings. A training
cell's readings need no window (`--seconds 0` runs none); a
reconstruction cell runs a short one at its own load."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)


def side_of(what: str):
    """program; control (the reference in float8 in the program's place);
    ref32 (the reference in float32 in the program's place: what rounding
    to bfloat16 alone moves); or a planted fault (`faults.planted`)."""
    from harness import faults, sides
    if what == "program":
        return sides.program()
    if what == "control":
        return sides.Side("refmodel", precision="fp8", name="control")
    if what == "ref32":
        return sides.Side("refmodel", precision="float32", name="ref32")
    return faults.planted(what)


def readings(cell, whats: list, seed: int, seconds: float,
             device="cuda") -> dict:
    """{what: (readings, detail)} of each side on `seed` against one run
    of the reference."""
    from harness.entries import common
    entry = cell.entry
    outs, st = {}, None
    for what in whats:
        st = entry.setup(cell, seed, device, side=side_of(what))
        if seconds > 0:
            entry.window(st, seconds)
        outs[what] = entry.outputs(st)
        if what != whats[-1]:
            st.model = st.opt = st.pool = st.gen = None
            st.kept = {}
            common.free(device)
    ref = entry.reference(st)
    return {what: entry.readings(outs[what], ref) for what in whats}


def look(cell, seed: int, device="cuda") -> dict:
    """Where the program and the reference part on `seed`: both sides'
    first forward (the training forward on the first batch with the
    generator seeded alike, or `reconstruct` on the first sampled batch)
    from the same weights, without gradients, and the discrete choices
    each made: the pose hypothesis of each image and the reference's
    margin between its two most probable, the prior mesh's vertices and
    faces, the lattice SDF's signs, the bones, the articulation and the
    rendered mask."""
    import torch
    from harness import sides, traffic, weights
    from harness.entries import common
    w, entry = cell.workload, cell.workload["entry"]
    common.float32_numerics()
    wseed, tseed, third = common.seeds(seed, 3)
    name = cell.config["port_configs"][entry]
    ov = list(cell.config.get("overrides", [])) + list(w.get("overrides",
                                                             []))
    state = weights.make(sides.reference().load_config(name, ov), wseed,
                         device)
    outs = {}
    for side in (sides.program(), sides.reference(cell.config["precision"])):
        cfg = side.load_config(name, ov)
        side.set_precision(cfg)
        model = side.build(cfg, device)
        model.load_state_dict(state)
        with torch.no_grad():
            if entry == "train":
                batch = traffic.pool(1, w["batch"], model.in_image_size,
                                     model.num_frames,
                                     model.dino_feature_dim, tseed,
                                     device)[0]
                gen = torch.Generator(device=device).manual_seed(third)
                it = int(w["iteration"])
                _loss, (_m, aux) = model.forward(
                    batch, it, gen, model.phase_for_iter(it))
                o = {"rot_idx": aux["rot_idx"], "probs": aux["rots_probs"],
                     "verts": aux["prior_mesh"].num_verts,
                     "faces": aux["prior_mesh"].num_faces,
                     "sdf": aux["sdf"], "bones": aux["posed_bones"],
                     "arti": aux["arti_params"], "mask": aux["mask_pred"],
                     "pose": aux["pose"], "deform": aux["deformation"],
                     "vpos": aux["shape"].v_pos, "rgb": aux["image_pred"],
                     "loss": _loss}
            else:
                images = traffic.image_pool(w["pool"], w["batch"],
                                            model.in_image_size,
                                            model.num_frames, tseed,
                                            device)[0]
                rgba, out = model.reconstruct(model, images, w["iteration"])
                o = {"rot_idx": out[11]["rot_idx"],
                     "probs": out[11]["rots_probs"],
                     "verts": out[0].num_verts, "faces": out[0].num_faces,
                     "bones": out[11].get("posed_bones"), "arti": out[9],
                     "mask": rgba[:, 3]}
        outs[side.name] = {k: (v.detach().float().cpu()
                               if torch.is_tensor(v) else v)
                           for k, v in o.items()}
        del model
        common.free(device)
    p, r = outs["program"], outs["reference"]
    top = r["probs"].sort(-1, descending=True).values
    res = {"rot_idx": p["rot_idx"].long().tolist(),
           "ref_rot_idx": r["rot_idx"].long().tolist(),
           "ref_margin": (top[:, 0] - top[:, 1]).tolist(),
           "verts": [float(p["verts"]), float(r["verts"])],
           "faces": [float(p["faces"]), float(r["faces"])],
           "mask_gap_per_image": (p["mask"] - r["mask"]).abs()
           .flatten(1).mean(1).tolist()}
    if p.get("sdf") is not None:
        res["sdf_sign_flips"] = int(((p["sdf"] > 0) != (r["sdf"] > 0)).sum())
    if "loss" in p:
        res["loss"] = [float(p["loss"]), float(r["loss"])]
    for k in ("bones", "arti", "pose", "deform", "vpos", "rgb"):
        if p.get(k) is not None and r.get(k) is not None and \
                p[k].shape == r[k].shape:
            res[k + "_gap_per_image"] = (p[k] - r[k]).abs().flatten(1) \
                .amax(1).tolist()
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--what", default="program")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--look", action="store_true",
                   help="where program and reference part, per seed")
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.append(REPO)
    from harness import spec
    cell = spec.load_cell(args.workload)
    if args.look:
        for seed in [int(s) for s in args.seeds.split(",")]:
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "look": look(cell, seed)}), flush=True)
        return 0
    whats = args.what.split(",")
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        res = readings(cell, whats, seed, args.seconds)
        for what, (reads, detail) in res.items():
            print(json.dumps({"workload": cell.name, "what": what,
                              "seed": seed, "readings": reads,
                              "detail": detail,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
