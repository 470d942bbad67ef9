"""Fauna base predictor: the semantic memory bank and the conditional prior
shape (port of `animals3d_tpu.predictors.bank`).

The bank (size × 128) starts as a tiled 7-row uniform block and its keys
(size × 384) as a uniform draw. A frozen-ViT class token per image
queries the keys by cosine similarity; the top-k values are blended with
L1-normalised weights, and the batch mean of the blended embeddings
conditions the modulated SDF and the DINO field (`condition_choice`
"mod").
"""
from __future__ import annotations

import torch
from torch import nn

from animals3d_tpu_torch.predictors.base import BasePredictor
from animals3d_tpu_torch.predictors.config import (BankConfig,
                                                   BasePredictorConfig)


def _l2_normalize(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


class BankPredictor(BasePredictor):

    def __init__(self, cfg: BasePredictorConfig, bank_cfg: BankConfig):
        super().__init__(cfg, condition_choice="mod",
                         dino_extra_feat_dim=bank_cfg.memory_bank_dim)
        self.bank_cfg = bank_cfg
        self.memory_bank = nn.Parameter(torch.empty(
            bank_cfg.memory_bank_size, bank_cfg.memory_bank_dim))
        self.memory_bank_keys = nn.Parameter(torch.empty(
            bank_cfg.memory_bank_size, bank_cfg.memory_bank_keys_dim))

    def init_weights(self, gen: torch.Generator):
        """The bank: a (7, dim) U(±0.05) block tiled to its size; the keys:
        U(±0.05). The submodules initialize themselves."""
        size, dim = self.memory_bank.shape
        with torch.no_grad():
            block = torch.empty(7, dim).uniform_(-0.05, 0.05, generator=gen)
            self.memory_bank.copy_(block.repeat(-(-size // 7), 1)[:size])
            self.memory_bank_keys.uniform_(-0.05, 0.05, generator=gen)

    def retrieve_memory_bank(self, batch_features):
        """batch_features (N, key_dim), the class tokens → (batch-mean
        embedding (dim,), per-image embeddings (N, dim), {"weights",
        "pick_idx"}). The top k are taken by a stable descending sort:
        `jax.lax.top_k`'s indices in its order, the lower index first
        among equal similarities."""
        k = self.bank_cfg.memory_bank_topk
        cos = _l2_normalize(batch_features.float()) \
            @ _l2_normalize(self.memory_bank_keys).T           # (N, size)
        weights, idx = torch.sort(cos, dim=-1, descending=True, stable=True)
        weights, idx = weights[:, :k], idx[:, :k]
        weights = weights / torch.clamp(weights.abs().sum(-1, keepdim=True),
                                        min=1e-12)
        picked = self.memory_bank.index_select(0, idx.reshape(-1)) \
            .reshape(*idx.shape, -1)                           # (N, k, dim)
        out = (weights[..., None] * picked).sum(1)             # (N, dim)
        return out.mean(0), out, {"weights": weights, "pick_idx": idx}
