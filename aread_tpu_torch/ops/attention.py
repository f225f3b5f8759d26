"""Self-attention over field embeddings (counterpart of
``aread_tpu/ops/attention.py``): ``torch.nn.MultiheadAttention``'s math
for self-attention over [B, L, E] — packed in-projection, per-head scaled
dot product, dropout on the attention weights, out-projection — written
out, and the AutoInt-style side tower built from it.

The products are plain ``matmul`` / ``einsum`` as in the JAX package. The
packed in-projection keeps the JAX package's ``[E, 3E]`` layout
(``in_proj_kernel``) and the dropout sits where it sits there, so weights
convert one to one; ``torch.nn.MultiheadAttention`` would give neither.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from aread_tpu_torch.ops.mlp import Linear, dropout


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.embed_dim, self.num_heads, self.rate = embed_dim, num_heads, dropout
        # xavier-uniform over the packed weight, zero bias, as torch's MHA
        bound = math.sqrt(6.0 / (embed_dim + 3 * embed_dim))
        u = torch.rand((embed_dim, 3 * embed_dim), generator=generator,
                       device=device)
        self.in_proj_kernel = nn.Parameter(u * (2 * bound) - bound)
        self.in_proj_bias = nn.Parameter(torch.zeros((3 * embed_dim,),
                                                     device=device))
        self.out_proj = Linear(embed_dim, embed_dim, generator=generator,
                               device=device)

    def forward(self, x, train: bool = False, generator=None):
        e, h = self.embed_dim, self.num_heads
        head_dim = e // h
        B, L = x.shape[0], x.shape[1]
        qkv = x @ self.in_proj_kernel + self.in_proj_bias  # [B, L, 3E]
        q, k, v = torch.split(qkv, e, dim=-1)

        def split_heads(t):
            return t.reshape(B, L, h, head_dim).permute(0, 2, 1, 3)

        q, k, v = split_heads(q), split_heads(k), split_heads(v)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(head_dim)
        weights = torch.softmax(scores, dim=-1)
        weights = dropout(weights, self.rate, train, generator)
        out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
        out = out.permute(0, 2, 1, 3).reshape(B, L, e)
        return self.out_proj(out)


class AttentionTower(nn.Module):
    """Project the fields to ``atten_embed_dim``, stack self-attention
    layers, optional value residual, ReLU, flatten, Linear(1, no bias)."""

    def __init__(self, field_num: int, embed_dim: int,
                 atten_embed_dim: int = 64, att_layer_num: int = 3,
                 att_head_num: int = 2, att_res: bool = True,
                 dropout: float = 0.2,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.field_num, self.embed_dim = field_num, embed_dim
        self.atten_embed_dim = atten_embed_dim
        self.att_layer_num = att_layer_num
        kw = dict(generator=generator, device=device)
        self.atten_embedding = Linear(embed_dim, atten_embed_dim, **kw)
        for i in range(att_layer_num):
            self.add_module(f"attn_{i}", MultiHeadSelfAttention(
                atten_embed_dim, att_head_num, dropout, **kw))
        self.v_res = Linear(embed_dim, atten_embed_dim, **kw) if att_res else None
        self.atten_linear = Linear(field_num * atten_embed_dim, 1,
                                   use_bias=False, **kw)

    def forward(self, embed_x_flat, train: bool = False, generator=None):
        x = embed_x_flat.reshape(-1, self.field_num, self.embed_dim)
        cross = self.atten_embedding(x)
        for i in range(self.att_layer_num):
            cross = getattr(self, f"attn_{i}")(cross, train=train,
                                               generator=generator)
        if self.v_res is not None:
            cross = cross + self.v_res(x)
        cross = torch.relu(cross).reshape(-1, self.field_num * self.atten_embed_dim)
        return self.atten_linear(cross)
