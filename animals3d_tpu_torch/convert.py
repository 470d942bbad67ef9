"""Reference `.pth` checkpoint → flax-layout parameter tree (the MagicPony
parts of `animals3d_tpu.convert`).

The reference saves `{netBase, netInstance, optimizer*, epoch,
total_iter}` torch state dicts (`reference model/Trainer.py:108-123`,
`AnimalModel.py:126-156`). This module maps those flat `a.b.c → tensor`
dicts onto the flax parameter tree's layout, which
`convert_jax.load_jax_params` carries onto the port's modules:

  * Linear: torch (out, in) → Dense kernel (in, out)
  * Conv2d: torch (out, in, kh, kw) → Conv kernel (kh, kw, in, out)
  * GroupNorm/LayerNorm weight/bias → scale/bias
  * `nn.Sequential` indices → named layers (MLP `network.{0,2,4,...}` →
    `layer_{0..}`; Encoder32 `network.{0,1,3,4,6,7,9}` → conv_/norm_{0..2},
    conv_out)

Fauna's parts are here too: the mod-demod SDF (`convert_coord_mlp_mod`),
the memory bank and its keys, and the mask discriminator
(`convert_discriminator`); and Ponymation's motion VAE
(`convert_motion_vae`: torch `nn.MultiheadAttention`'s packed
`in_proj_weight` splits into q, k and v); and the torchvision-architecture
encoders (`convert_vgg_encoder`, `convert_resnet_encoder`,
`convert_resnet_depth_encoder`: BatchNorm running statistics become the
frozen norm's `mean` and `var`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _t(x):
    return np.asarray(x, np.float32)


def linear(sd, prefix, bias=True):
    out = {"kernel": _t(sd[f"{prefix}.weight"]).T}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def conv(sd, prefix, bias=False):
    out = {"kernel": _t(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def norm(sd, prefix):
    return {"scale": _t(sd[f"{prefix}.weight"]),
            "bias": _t(sd[f"{prefix}.bias"])}


def sub(sd: Dict, prefix: str) -> Dict:
    p = prefix + "."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def convert_mlp(sd, num_layers):
    """reference MLP (Sequential of bias-free Linears, `MLPs.py:9-31`)."""
    out = {}
    seq_idx = 0
    for i in range(num_layers):
        out[f"layer_{i}"] = linear(sd, f"network.{seq_idx}", bias=False)
        seq_idx += 2 if i < num_layers - 1 else 1
    return out


def convert_mlp_mod(sd, num_layers):
    """reference MLP_Mod (`MLPs.py:183-205`): `LinearMod` weights (out, in)
    → the flax `weight` leaf (in, out)."""
    return {f"linear_{i}": {"weight": _t(sd[f"linear_{i}.weight"]).T}
            for i in range(num_layers)}


def convert_coord_mlp_mod(sd, num_layers):
    """reference CoordMLP_Mod (`MLPs.py:104-169`)."""
    return {"in_layer": linear(sd, "in_layer"),
            "style_mlp": convert_mlp(sub(sd, "style_mlp"), 2),
            "mlp": convert_mlp_mod(sub(sd, "mlp"), num_layers)}


def convert_discriminator(sd, n_layers=6):
    """reference DCDiscriminator (`discriminator_architecture.py:8-66`):
    `blocks.{i}` → conv_{i}, `conv_out`."""
    out = {f"conv_{i}": conv(sd, f"blocks.{i}") for i in range(n_layers)}
    out["conv_out"] = conv(sd, "conv_out", bias="conv_out.bias" in sd)
    return out


def convert_coord_mlp(sd, num_layers):
    """reference CoordMLP (`MLPs.py:34-101`)."""
    return {"in_layer": linear(sd, "in_layer"),
            "mlp": convert_mlp(sub(sd, "mlp"), num_layers)}


def convert_encoder32(sd):
    """reference Encoder32 Sequential (`encoders.py:68-89`)."""
    return {"conv_0": conv(sd, "network.0"), "norm_0": norm(sd, "network.1"),
            "conv_1": conv(sd, "network.3"), "norm_1": norm(sd, "network.4"),
            "conv_2": conv(sd, "network.6"), "norm_2": norm(sd, "network.7"),
            "conv_out": conv(sd, "network.9")}


def batchnorm(sd, prefix):
    """torch BatchNorm2d (weight, bias, running stats) → FrozenBatchNorm."""
    return {"scale": _t(sd[f"{prefix}.weight"]),
            "bias": _t(sd[f"{prefix}.bias"]),
            "mean": _t(sd[f"{prefix}.running_mean"]),
            "var": _t(sd[f"{prefix}.running_var"])}


def convert_vgg16_features(sd, prefix="features"):
    """torchvision vgg16 `features` Sequential → VGG16Features (the convs
    at Sequential indices 0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26,
    28)."""
    idxs = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    return {f"conv_{i}": conv(sd, f"{prefix}.{j}", bias=True)
            for i, j in enumerate(idxs)}


def convert_vgg_encoder(sd):
    """reference VGGEncoder (`encoders.py:91-106`): `vgg_encoder.0` holds
    vgg16's features; linear1 and linear2 replace its classifier."""
    return {"features": convert_vgg16_features(sd, "vgg_encoder.0"),
            "linear1": linear(sd, "linear1"),
            "linear2": linear(sd, "linear2")}


def convert_resnet18_trunk(sd, prefix=""):
    """torchvision resnet18 (without fc) → ResNet18Trunk."""
    p = (prefix + ".") if prefix else ""
    out = {"conv1": conv(sd, f"{p}conv1"), "bn1": batchnorm(sd, f"{p}bn1")}
    for li in range(1, 5):
        for bi in range(2):
            bp = f"{p}layer{li}.{bi}"
            blk = {"conv1": conv(sd, f"{bp}.conv1"),
                   "bn1": batchnorm(sd, f"{bp}.bn1"),
                   "conv2": conv(sd, f"{bp}.conv2"),
                   "bn2": batchnorm(sd, f"{bp}.bn2")}
            if f"{bp}.downsample.0.weight" in sd:
                blk["downsample"] = conv(sd, f"{bp}.downsample.0")
                blk["downsample_bn"] = batchnorm(sd, f"{bp}.downsample.1")
            out[f"layer{li}_{bi}"] = blk
    return out


def convert_resnet_encoder(sd):
    """reference ResnetEncoder (`encoders.py:108-115`)."""
    return {"resnet": convert_resnet18_trunk(sd, "resnet"),
            "final_linear": linear(sd, "final_linear")}


def convert_resnet_depth_encoder(sd):
    """reference ResnetDepthEncoder (`encoders.py:117-146`): the trunk
    under `resnet.`."""
    return {"resnet": convert_resnet18_trunk(sd, "resnet")}


def convert_vit_block(sd):
    """DINO ViT block → networks.vit.ViTBlock."""
    return {
        "norm1": norm(sd, "norm1"),
        "norm2": norm(sd, "norm2"),
        "attn": {"qkv": linear(sd, "attn.qkv"),
                 "proj": linear(sd, "attn.proj")},
        "fc1": linear(sd, "mlp.fc1"),
        "fc2": linear(sd, "mlp.fc2"),
    }


def convert_dino_vit(sd, depth=12):
    """facebookresearch/dino VisionTransformer state dict → DinoViT."""
    out = {
        "patch_embed": conv(sd, "patch_embed.proj", bias=True),
        "cls_token": _t(sd["cls_token"]),
        "pos_embed": _t(sd["pos_embed"]),
        "norm": norm(sd, "norm"),
    }
    for i in range(depth):
        out[f"block_{i}"] = convert_vit_block(sub(sd, f"blocks.{i}"))
    return out


def convert_vit_encoder(sd, depth=12):
    """reference ViTEncoder (`encoders.py:148-261`)."""
    out = {"ViT": convert_dino_vit(sub(sd, "ViT"), depth)}
    if any(k.startswith("final_layer_patch_out") for k in sd):
        out["final_layer_patch_out"] = convert_encoder32(
            sub(sd, "final_layer_patch_out"))
        out["final_layer_patch_key"] = convert_encoder32(
            sub(sd, "final_layer_patch_key"))
    return out


def convert_articulation_net(sd, num_layers, architecture="attention"):
    """reference ArticulationNetwork (`ArticulationNetwork.py:10-67`)."""
    if architecture == "mlp":
        return {"network": convert_mlp(sub(sd, "network"), num_layers)}
    out = {"in_linear": linear(sd, "in_layer.0"),
           "in_norm": norm(sd, "in_layer.2"),
           "out_linear": linear(sd, "out_layer.0")}
    for i in range(num_layers):
        b = sub(sd, f"blocks.{i}")
        out[f"block_{i}"] = {
            "norm1": norm(b, "norm1"), "norm2": norm(b, "norm2"),
            "qkv": linear(b, "attn.qkv", bias="attn.qkv.bias" in b),
            "proj": linear(b, "attn.proj"),
            "fc1": linear(b, "mlp.fc1"), "fc2": linear(b, "mlp.fc2"),
        }
    return out


def convert_mha(sd, prefix):
    """torch `nn.MultiheadAttention` → `networks.motion_vae.MHA`: the
    packed `in_proj_weight` / `in_proj_bias` split into q, k and v."""
    w = _t(sd[f"{prefix}.in_proj_weight"])
    b = _t(sd[f"{prefix}.in_proj_bias"])
    d = w.shape[0] // 3
    return {"q": {"kernel": w[:d].T, "bias": b[:d]},
            "k": {"kernel": w[d:2 * d].T, "bias": b[d:2 * d]},
            "v": {"kernel": w[2 * d:].T, "bias": b[2 * d:]},
            "proj": linear(sd, f"{prefix}.out_proj")}


def convert_transformer_enc_layer(sd):
    return {"self_attn": convert_mha(sd, "self_attn"),
            "linear1": linear(sd, "linear1"),
            "linear2": linear(sd, "linear2"),
            "norm1": norm(sd, "norm1"), "norm2": norm(sd, "norm2")}


def convert_transformer_dec_layer(sd):
    return {"self_attn": convert_mha(sd, "self_attn"),
            "cross_attn": convert_mha(sd, "multihead_attn"),
            "linear1": linear(sd, "linear1"),
            "linear2": linear(sd, "linear2"),
            "norm1": norm(sd, "norm1"), "norm2": norm(sd, "norm2"),
            "norm3": norm(sd, "norm3")}


def convert_motion_vae(sd, num_layers=4):
    """The reference's ArticulationVAE (`MotionVAE.py:130-222`)."""
    enc = sub(sd, "encoder")
    dec = sub(sd, "decoder")
    out = {
        "in_dense": linear(sd, "in_layer.0"),
        "in_norm": norm(sd, "in_layer.2"),
        "encoder": {
            "boneFeatQuery": _t(enc["boneFeatQuery"]),
            "muQuery": _t(enc["muQuery"]),
            "sigmaQuery": _t(enc["sigmaQuery"]),
            "skelEmbedding": linear(enc, "skelEmbedding"),
        },
        "decoder": {"finallayer": linear(dec, "finallayer")},
    }
    for i in range(num_layers):
        out["encoder"][f"bone_{i}"] = convert_transformer_enc_layer(
            sub(enc, f"boneTransEncoder.layers.{i}"))
        out["encoder"][f"seq_{i}"] = convert_transformer_enc_layer(
            sub(enc, f"seqTransEncoder.layers.{i}"))
        out["decoder"][f"seq_{i}"] = convert_transformer_dec_layer(
            sub(dec, f"seqTransDecoder.layers.{i}"))
        out["decoder"][f"bone_{i}"] = convert_transformer_dec_layer(
            sub(dec, f"boneTransDecoder.layers.{i}"))
    return out


def convert_directional_light(sd, num_layers):
    return {"mlp": convert_mlp(sub(sd, "mlp"), num_layers)}


def convert_net_base(sd, model):
    cfg = model.cfg_predictor_base
    shape_layers = cfg.cfg_shape.num_layers
    out = {}
    if any(k.startswith("netShape.mlp.style_mlp") for k in sd):
        out["netSDF"] = convert_coord_mlp_mod(sub(sd, "netShape.mlp"),
                                              shape_layers)
    else:
        out["netSDF"] = convert_coord_mlp(sub(sd, "netShape.mlp"),
                                          shape_layers)
    out["netDINO"] = convert_coord_mlp(sub(sd, "netDINO"),
                                       cfg.cfg_dino.num_layers)
    if "memory_bank" in sd:
        out["memory_bank"] = _t(sd["memory_bank"])
        out["memory_bank_keys"] = _t(sd["memory_bank_keys"])
    return out


def convert_net_instance(sd, model):
    cfg = model.cfg_predictor_instance
    out = {
        "netEncoder": convert_vit_encoder(sub(sd, "netEncoder")),
        "netTexture": convert_coord_mlp(sub(sd, "netTexture"),
                                        cfg.cfg_texture.num_layers),
        "netPose": convert_encoder32(sub(sd, "netPose")),
    }
    if any(k.startswith("netDeform") for k in sd):
        out["netDeform"] = convert_coord_mlp(sub(sd, "netDeform"),
                                             cfg.cfg_deform.num_layers)
    if any(k.startswith("netArticulation") for k in sd):
        out["netArticulation"] = convert_articulation_net(
            sub(sd, "netArticulation"), cfg.cfg_articulation.num_layers,
            cfg.cfg_articulation.architecture)
    if any(k.startswith("netLight") for k in sd):
        out["netLight"] = convert_directional_light(
            sub(sd, "netLight"), cfg.cfg_light.num_layers)
    if any(k.startswith("netVAE") for k in sd):
        out["netVAE"] = convert_motion_vae(
            sub(sd, "netVAE"), model.cfg_motion_vae.transformer_layer_num)
    return out


def load_torch_state_dict(path):
    import torch
    cp = torch.load(path, map_location="cpu", weights_only=False)

    def arr(v):
        return v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)

    return {k: ({kk: arr(vv) for kk, vv in v.items()}
                if hasattr(v, "items") and k.startswith(("net", "optimizer"))
                else v)
            for k, v in cp.items()}


def convert_checkpoint(path_or_cp, model) -> dict:
    """Reference checkpoint file (or loaded dict) → flax-layout tree of the
    nets it holds. Nets absent from the file are absent from the tree
    (the reference loads with strict=False, `AnimalModel.py:127-132`), and
    keep their init under `load_jax_params(..., strict=False)`."""
    cp = load_torch_state_dict(path_or_cp) if isinstance(path_or_cp, str) \
        else path_or_cp
    params = {}
    if "netBase" in cp:
        params["netBase"] = convert_net_base(cp["netBase"], model)
    if "netInstance" in cp:
        params["netInstance"] = convert_net_instance(cp["netInstance"],
                                                     model)
    if "netDisc" in cp:
        params["netDisc"] = convert_discriminator(cp["netDisc"],
                                                  model.netDisc.n_layers)
    return params
