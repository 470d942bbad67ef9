"""Transformer motion VAE over articulation sequences (port of
`animals3d_tpu.networks.motion_vae`).

Post-norm transformer layers (4 heads, feed-forward 1024, exact GELU,
LayerNorm eps 1e-5) in the (T, B, D) layout of torch's
`nn.MultiheadAttention`, written out so that each product and the float32
softmax of (q kᵀ)·hd^-0.5 run in the JAX package's order; sinusoidal
positional encodings; a `boneFeatQuery` token pooling the bone tokens of
each frame; learned `muQuery` / `sigmaQuery` tokens on the sequence
transformer; z of shape (z_tokens, B, latent). The decoder runs a
sequence transformer-decoder over F time queries that cross-attends z,
then a bone transformer-decoder over bone queries. `sample` decodes
z ~ 1.5·N(0, 1). Submodules carry the flax tree's names (`q`, `k`, `v`,
`proj`, `linear1`, `norm1`, `bone_{i}`, `seq_{i}`, `skelEmbedding`, ...),
so `convert_jax.load_jax_params` maps them by name. Every layer computes
in float32, as flax `nn.Dense` without a dtype does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animals3d_tpu_torch.networks.articulation import LayerNorm5, _dense32
from animals3d_tpu_torch.networks.mlp import harmonic_embedding


def sinusoidal_pe(length: int, dim: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    pe = np.zeros((length, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def _pe(length, dim, like):
    return torch.as_tensor(sinusoidal_pe(length, dim), device=like.device)


class MHA(nn.Module):
    """(Tq, B, D) queries × (Tk, B, D) keys and values → (Tq, B, D)."""

    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.q = _dense32(dim, dim)
        self.k = _dense32(dim, dim)
        self.v = _dense32(dim, dim)
        self.proj = _dense32(dim, dim)

    def forward(self, q, kv):
        H, hd = self.heads, self.dim // self.heads

        def split(x):                                   # (B, H, T, hd)
            return x.reshape(x.shape[0], x.shape[1], H, hd) \
                .permute(1, 2, 0, 3)
        qh, kh, vh = split(self.q(q)), split(self.k(kv)), split(self.v(kv))
        attn = torch.softmax((qh @ kh.transpose(-1, -2)) * hd ** -0.5, -1)
        out = (attn @ vh).permute(2, 0, 1, 3) \
            .reshape(q.shape[0], q.shape[1], self.dim)
        return self.proj(out)


class EncoderLayer(nn.Module):
    """torch `nn.TransformerEncoderLayer`'s post-norm, GELU form."""

    def __init__(self, dim: int, heads: int = 4, ff: int = 1024):
        super().__init__()
        self.self_attn = MHA(dim, heads)
        self.norm1 = LayerNorm5(dim)
        self.linear1 = _dense32(dim, ff)
        self.linear2 = _dense32(ff, dim)
        self.norm2 = LayerNorm5(dim)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x, x))
        h = self.linear2(F.gelu(self.linear1(x), approximate="none"))
        return self.norm2(x + h)


class DecoderLayer(nn.Module):
    """torch `nn.TransformerDecoderLayer`'s post-norm, GELU form."""

    def __init__(self, dim: int, heads: int = 4, ff: int = 1024):
        super().__init__()
        self.self_attn = MHA(dim, heads)
        self.norm1 = LayerNorm5(dim)
        self.cross_attn = MHA(dim, heads)
        self.norm2 = LayerNorm5(dim)
        self.linear1 = _dense32(dim, ff)
        self.linear2 = _dense32(ff, dim)
        self.norm3 = LayerNorm5(dim)

    def forward(self, tgt, memory):
        tgt = self.norm1(tgt + self.self_attn(tgt, tgt))
        tgt = self.norm2(tgt + self.cross_attn(tgt, memory))
        h = self.linear2(F.gelu(self.linear1(tgt), approximate="none"))
        return self.norm3(tgt + h)


class VAEEncoder(nn.Module):
    """The learned query tokens are flax `param`s with a standard normal
    init (`init_weights`)."""

    def __init__(self, latent_dim: int = 256, num_layers: int = 4):
        super().__init__()
        self.latent_dim, self.num_layers = latent_dim, num_layers
        for n in ("boneFeatQuery", "muQuery", "sigmaQuery"):
            setattr(self, n, nn.Parameter(torch.zeros(1, 1, latent_dim)))
        self.skelEmbedding = _dense32(latent_dim, latent_dim)
        for i in range(num_layers):
            setattr(self, f"bone_{i}", EncoderLayer(latent_dim))
            setattr(self, f"seq_{i}", EncoderLayer(latent_dim))

    def init_weights(self, gen):
        with torch.no_grad():
            for n in ("boneFeatQuery", "muQuery", "sigmaQuery"):
                getattr(self, n).normal_(generator=gen)

    def forward(self, x):
        """x: (B, J, D, F) per-bone embedded features → (mu, logvar)
        (B, D)."""
        B, J, D, Fr = x.shape
        L = self.latent_dim
        # the bone transformer: tokens [query, bones] per (B·F)
        xb = x.permute(1, 0, 3, 2).reshape(J, B * Fr, D)
        xb = self.skelEmbedding(xb)
        xb = torch.cat([self.boneFeatQuery.expand(1, B * Fr, L), xb], 0)
        for i in range(self.num_layers):
            xb = getattr(self, f"bone_{i}")(xb)
        pooled = xb[0].reshape(B, Fr, L).transpose(0, 1)
        # the sequence transformer with the mu/sigma queries
        xs = torch.cat([self.muQuery.expand(1, B, L),
                        self.sigmaQuery.expand(1, B, L), pooled], 0)
        xs = xs + _pe(xs.shape[0], L, xs)[:, None, :]
        for i in range(self.num_layers):
            xs = getattr(self, f"seq_{i}")(xs)
        return xs[0], xs[1]


class VAEDecoder(nn.Module):
    def __init__(self, njoints: int, nfeats: int = 3, latent_dim: int = 256,
                 num_layers: int = 4):
        super().__init__()
        self.njoints, self.nfeats = njoints, nfeats
        self.latent_dim, self.num_layers = latent_dim, num_layers
        for i in range(num_layers):
            setattr(self, f"seq_{i}", DecoderLayer(latent_dim))
            setattr(self, f"bone_{i}", DecoderLayer(latent_dim))
        self.finallayer = _dense32(latent_dim, nfeats)

    def forward(self, z, nframes: int):
        """z: (z_tokens, B, D) → (B, J, nfeats, F)."""
        _, B, D = z.shape
        seq = _pe(nframes, D, z)[:, None, :].expand(nframes, B, D)
        for i in range(self.num_layers):
            seq = getattr(self, f"seq_{i}")(seq, z)
        seq = seq.reshape(1, nframes * B, D)
        bones = _pe(self.njoints, D, z)[:, None, :].expand(
            self.njoints, nframes * B, D)
        for i in range(self.num_layers):
            bones = getattr(self, f"bone_{i}")(bones, seq)
        out = self.finallayer(bones)
        return out.reshape(self.njoints, nframes, B, self.nfeats) \
            .permute(2, 0, 3, 1)


class ArticulationVAE(nn.Module):
    def __init__(self, njoints: int = 20, feat_dim: int = 640,
                 pos_dim: int = 9, n_harmonic_functions: int = 8,
                 harmonic_omega0: float = np.pi * 0.9,
                 latent_dim: int = 256, z_token_num: int = 1,
                 transformer_layer_num: int = 4):
        super().__init__()
        self.njoints = njoints
        self.n_harmonic_functions = n_harmonic_functions
        self.harmonic_omega0 = harmonic_omega0
        self.latent_dim = latent_dim
        self.z_token_num = z_token_num
        nfeats = feat_dim + pos_dim * (n_harmonic_functions * 2 + 1)
        self.in_dense = _dense32(nfeats, latent_dim)
        self.in_norm = LayerNorm5(latent_dim)
        self.encoder = VAEEncoder(latent_dim, transformer_layer_num)
        self.decoder = VAEDecoder(njoints, 3, latent_dim,
                                  transformer_layer_num)

    def _embed(self, inputs, pos):
        pos = torch.cat([pos, harmonic_embedding(
            pos, self.n_harmonic_functions, self.harmonic_omega0)], -1)
        x = torch.cat([inputs.to(pos.dtype), pos], -1)
        return self.in_norm(F.gelu(self.in_dense(x), approximate="none"))

    def forward(self, inputs, pos, nframes: int, batch_size: int, eps):
        """inputs (B·F, J, feat), pos (B·F, J, pos_dim), eps (z_tokens, B,
        latent) standard normal → (angles (B, F, J, 3), mu, logvar)."""
        x = self._embed(inputs, pos)
        x = x.reshape(batch_size, nframes, self.njoints, self.latent_dim) \
            .permute(0, 2, 3, 1)                      # (B, J, D, F)
        mu, logvar = self.encoder(x)
        std = torch.exp(0.5 * logvar)
        z = eps * std[None] + mu[None]
        out = self.decoder(z, nframes)                # (B, J, 3, F)
        return out.permute(0, 3, 1, 2), mu, logvar

    def sample(self, z_normal, num_frames: int = 10):
        """Decode z = 1.5 · `z_normal` (z_tokens, num_sequence, latent) →
        angles (num_sequence, F, J, 3)."""
        out = self.decoder(z_normal * 1.5, num_frames)
        return out.permute(0, 3, 1, 2)
