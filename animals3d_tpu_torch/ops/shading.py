"""Shading math: normal preparation, BSDFs, sRGB and HDR image losses
(port of `animals3d_tpu.ops.shading`, the reference's renderutils
family: `renderutils/bsdf.py`, `loss.py`). Elementwise chains; autograd
gives their backward."""
from __future__ import annotations

import math

import torch

_SPEC_EPS = 1e-4
_NORMAL_THRESHOLD = 0.1


def dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def reflect(x, n):
    return 2 * dot(x, n) * n - x


def safe_normalize(x, eps=1e-20):
    return x * torch.rsqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps))


def prepare_shading_normal(pos, view_pos, smooth_nrm, geom_nrm,
                           two_sided_shading: bool = True,
                           perturbed_nrm=None, smooth_tng=None,
                           opengl: bool = True):
    """Bent shading normal. With a tangent-space `perturbed_nrm` (a normal
    map) the smooth normal is first bent by it in the (tangent,
    bitangent, normal) frame of `smooth_tng`; then, for back-facing
    surfaces, both normals flip, and the geometric normal blends into the
    smooth one by how much the smooth normal faces the viewer (threshold
    0.1)."""
    smooth_nrm = safe_normalize(smooth_nrm)
    view_vec = safe_normalize(view_pos - pos)
    if perturbed_nrm is not None:
        smooth_tng = safe_normalize(smooth_tng)
        bitng = safe_normalize(torch.linalg.cross(
            *torch.broadcast_tensors(smooth_tng, smooth_nrm)))
        sgn = -1.0 if opengl else 1.0
        smooth_nrm = safe_normalize(
            smooth_tng * perturbed_nrm[..., 0:1]
            + sgn * bitng * perturbed_nrm[..., 1:2]
            + smooth_nrm * torch.clamp(perturbed_nrm[..., 2:3], min=0.0))
    if two_sided_shading:
        front = dot(geom_nrm, view_vec) > 0
        smooth_nrm = torch.where(front, smooth_nrm, -smooth_nrm)
        geom_nrm = torch.where(front, geom_nrm, -geom_nrm)
    t = torch.clamp(dot(view_vec, smooth_nrm) / _NORMAL_THRESHOLD, 0.0, 1.0)
    return geom_nrm + t * (smooth_nrm - geom_nrm)


# ---- BSDFs (`renderutils/bsdf.py:57-160`) ----------------------------------

def lambert(nrm, wi):
    return torch.clamp(dot(nrm, wi), min=0.0) / math.pi


def fresnel_shlick(f0, f90, cos_theta):
    c = torch.clamp(cos_theta, _SPEC_EPS, 1.0 - _SPEC_EPS)
    return f0 + (f90 - f0) * (1.0 - c) ** 5.0


def frostbite_diffuse(nrm, wi, wo, linear_roughness):
    wi_n = dot(wi, nrm)
    wo_n = dot(wo, nrm)
    h = safe_normalize(wo + wi)
    wi_h = dot(wi, h)
    f90 = 0.5 * linear_roughness + 2.0 * wi_h * wi_h * linear_roughness
    energy = 1.0 - (0.51 / 1.51) * linear_roughness
    res = fresnel_shlick(1.0, f90, wi_n) * fresnel_shlick(1.0, f90, wo_n) \
        * energy
    return torch.where((wi_n > 0.0) & (wo_n > 0.0), res,
                       torch.zeros_like(res))


def ndf_ggx(alpha_sqr, cos_theta):
    c = torch.clamp(cos_theta, _SPEC_EPS, 1.0 - _SPEC_EPS)
    d = (c * alpha_sqr - c) * c + 1.0
    return alpha_sqr / (d * d * math.pi)


def lambda_ggx(alpha_sqr, cos_theta):
    c = torch.clamp(cos_theta, _SPEC_EPS, 1.0 - _SPEC_EPS)
    tan_sqr = (1.0 - c * c) / (c * c)
    return 0.5 * (torch.sqrt(1.0 + alpha_sqr * tan_sqr) - 1.0)


def masking_smith(alpha_sqr, cos_theta_i, cos_theta_o):
    return 1.0 / (1.0 + lambda_ggx(alpha_sqr, cos_theta_i)
                  + lambda_ggx(alpha_sqr, cos_theta_o))


def pbr_specular(col, nrm, wo, wi, alpha, min_roughness=0.08):
    a = torch.clamp(alpha, min_roughness * min_roughness, 1.0)
    a2 = a * a
    h = safe_normalize(wo + wi)
    wo_n, wi_n = dot(wo, nrm), dot(wi, nrm)
    w = (fresnel_shlick(col, 1.0, dot(wo, h)) * ndf_ggx(a2, dot(nrm, h))
         * masking_smith(a2, wo_n, wi_n) * 0.25
         / torch.clamp(wo_n, min=_SPEC_EPS))
    return torch.where((wo_n > _SPEC_EPS) & (wi_n > _SPEC_EPS), w,
                       torch.zeros_like(w))


def pbr_bsdf(kd, arm, pos, nrm, view_pos, light_pos, min_roughness=0.08,
             bsdf="lambert"):
    wo = safe_normalize(view_pos - pos)
    wi = safe_normalize(light_pos - pos)
    spec_str, roughness, metallic = arm[..., 0:1], arm[..., 1:2], \
        arm[..., 2:3]
    ks = (0.04 * (1.0 - metallic) + kd * metallic) * (1.0 - spec_str)
    kd_eff = kd * (1.0 - metallic)
    if bsdf == "lambert":
        diffuse = kd_eff * lambert(nrm, wi)
    else:
        diffuse = kd_eff * frostbite_diffuse(nrm, wi, wo, roughness)
    return diffuse + pbr_specular(ks, nrm, wo, wi, roughness * roughness,
                                  min_roughness=min_roughness)


# ---- sRGB ------------------------------------------------------------------

def rgb_to_srgb(f):
    return torch.where(
        f > 0.0031308,
        torch.pow(torch.clamp(f, min=0.0031308), 1.0 / 2.4) * 1.055 - 0.055,
        12.92 * f)


def srgb_to_rgb(f):
    return torch.where(
        f > 0.04045,
        torch.pow((torch.clamp(f, min=0.04045) + 0.055) / 1.055, 2.4),
        f / 12.92)


# ---- HDR image losses (`renderutils/loss.py`) ------------------------------

def image_loss(img, target, loss="l1", tonemapper="none"):
    if tonemapper == "log_srgb":
        img = rgb_to_srgb(torch.log(torch.clamp(img, 0.0, 65535.0) + 1.0))
        target = rgb_to_srgb(torch.log(torch.clamp(target, 0.0, 65535.0)
                                       + 1.0))
    diff = img - target
    if loss == "mse":
        return (diff * diff).mean()
    if loss == "smape":
        return (diff.abs() / (img.abs() + target.abs() + 0.01)).mean()
    if loss == "relmse":
        return (diff * diff / (img * img + target * target + 0.1)).mean()
    return diff.abs().mean()


def mse_to_psnr(mse):
    return -10.0 * torch.log10(torch.clamp(torch.as_tensor(mse), min=1e-12))
