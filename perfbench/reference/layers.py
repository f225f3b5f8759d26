"""What the models of the plain reference share, in plain PyTorch: the
products, the shapes of the fused table and of stacked MLPs, and ``Net``,
one forward's layers (embedding, BatchNorm, dropout, stacked linears, the
cross network) over parameters by name. Each model is a module of its own
beside this one, ``perfbench/reference/<model>.py``, found by the model's
name (``perfbench.registry``).

Parameters are a dict name -> tensor under the names the models' modules
give them (``embedding.table``, ``towers_1.bn_0.scale``, ...), so that the
benchmark can hand one set of seed-made weights to both sides by name.

Every product goes through ``Products``: float32 with TF32 off, or, for
the control, float32 with each operand of every product (the gradient's
too) rounded to TF32's 10-bit mantissa, which is what a TF32 GEMM does
before it sums in float32.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import torch

F32 = torch.float32

# the table's l2 term is applied by its optimizer and reported beside the
# loss; a model's dense L2 (the reference zoo's manual L2) falls on the
# leaves its ``REG_RULES`` match, the first matching regex of the
# '/'-joined name
TABLE_L2 = 1e-5
REG_L2 = 1e-5


# ------------------------------------------------------------- products
def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (1 + 8 + 10 bits), round to nearest even, kept in
    float32."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    b = torch.where(b >= 2**31, b - 2**32, b)
    return b.to(torch.int32).view(F32)


class _Tf32Einsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eq, a, b):
        a32, b32 = round_tf32(a), round_tf32(b)
        ctx.eq = eq
        ctx.save_for_backward(a32, b32)
        return torch.einsum(eq, a32, b32)

    @staticmethod
    def backward(ctx, g):
        a32, b32 = ctx.saved_tensors
        lhs, out = ctx.eq.split("->")
        sa, sb = lhs.split(",")
        g32 = round_tf32(g)
        ga = torch.einsum(f"{out},{sb}->{sa}", g32, b32)
        gb = torch.einsum(f"{out},{sa}->{sb}", g32, a32)
        return None, ga, gb


class Products:
    """``ein(eq, a, b)``: a two-operand einsum at float32 ('f32') or with
    TF32 operands ('tf32', the control)."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "tf32"):
            raise ValueError(precision)
        self.precision = precision

    def ein(self, eq: str, a, b):
        if self.precision == "f32":
            return torch.einsum(eq, a, b)
        return _Tf32Einsum.apply(eq, a, b)


# ------------------------------------------------------------ the shapes
def table_rows(cfg: Dict) -> int:
    """Rows of the fused table: every one-hot vocabulary, grown to a whole
    number of 128-lane rows (128 / embed_dim rows each) as the packed
    storage of the sparse-gradient path pads it."""
    n = sum(cfg["one_hot_dims"])
    rpf = 128 // cfg["embed_dim"] if 128 % cfg["embed_dim"] == 0 else 1
    return n + (-n) % rpf


def field_num(cfg: Dict) -> int:
    return len(cfg["one_hot_dims"]) + cfg["n_seq_fields"]


def mlp_specs(name, n, din, dims, out=False):
    """(name, shape, how drawn) of ``n`` stacked MLPs of ``dims`` (each layer
    a linear and a BatchNorm, ``out``: a final Linear(1))."""
    specs = []
    for i, d in enumerate(dims):
        specs += [(f"{name}.linear_{i}.kernel", (n, din, d), "kernel"),
                  (f"{name}.linear_{i}.bias", (n, d), ("bias", din)),
                  (f"{name}.bn_{i}.scale", (n, d), "bn_scale"),
                  (f"{name}.bn_{i}.bias", (n, d), "bn_bias"),
                  (f"{name}.bn_{i}.mean", (n, d), "bn_mean"),
                  (f"{name}.bn_{i}.var", (n, d), "bn_var")]
        din = d
    if out:
        specs += [(f"{name}.out.kernel", (n, din, 1), "kernel"),
                  (f"{name}.out.bias", (n, 1), ("bias", din))]
    return specs


def head_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], object]]:
    """The table, the linear head and the cross network's leaves."""
    e = cfg["embed_dim"]
    flat = field_num(cfg) * e
    s = [("embedding.table", (table_rows(cfg), e), "table"),
         ("linear.kernel", (flat, 1), "kernel"),
         ("linear.bias", (1,), ("bias", flat))]
    for i in range(cfg["n_cross_layers"]):
        s += [(f"cn.w_{i}", (flat, 1), "kernel"),
              (f"cn.b_{i}", (flat,), ("bias", flat))]
    return s


def mlp_macs(n: int, din: int, dims) -> int:
    """Multiply-adds of one row through ``n`` stacked MLPs of ``dims``."""
    macs = 0
    for d in dims:
        macs += n * din * d
        din = d
    return macs


def is_buffer(name: str) -> bool:
    return name == "embedding.table" or name.endswith((".mean", ".var"))


# -------------------------------------------------------------- layers
class Net:
    """One forward of a model over parameters ``P`` (dict name -> tensor;
    the dense ones may require grad). ``gen``: the dropout generator, drawn
    in module order as the models draw it; ``valid`` [B] the rows that
    count in BatchNorm's statistics."""

    def __init__(self, cfg: Dict, P: Dict[str, torch.Tensor],
                 prods: Products, train: bool, valid=None, gen=None,
                 update_stats: bool = False):
        self.cfg, self.P, self.p = cfg, P, prods
        self.train, self.valid, self.gen = train, valid, gen
        self.rate = cfg["dropout"]
        # training forwards move BatchNorm's running statistics in place
        # (momentum 0.1, the unbiased variance), where ``gate`` allows
        self.update_stats = update_stats

    def dropout(self, x):
        if not self.train or self.rate <= 0:
            return x
        u = torch.rand(x.shape, generator=self.gen, device=x.device)
        return torch.where(u < 1.0 - self.rate, x / (1.0 - self.rate),
                           torch.zeros((), device=x.device))

    def bn(self, name, x, gate=None):
        P = self.P
        scale, bias = P[name + ".scale"], P[name + ".bias"]
        if not self.train:
            return ((x - P[name + ".mean"]) * torch.rsqrt(P[name + ".var"]
                                                          + 1e-5)
                    * scale + bias)
        w = (torch.ones(x.shape[0], device=x.device) if self.valid is None
             else self.valid.to(F32)).reshape((-1,) + (1,) * (x.dim() - 1))
        n = torch.clamp(w.sum(), min=1.0)
        mean = (x * w).sum(0) / n
        var = (torch.square(x - mean) * w).sum(0) / n
        out = (x - mean) * torch.rsqrt(var + 1e-5) * scale + bias
        if self.update_stats:
            with torch.no_grad():
                ok = n > 1.0
                if gate is not None:
                    ok = ok & gate.to(torch.bool)[:, None]
                rm, rv = P[name + ".mean"], P[name + ".var"]
                unbiased = var.detach() * n / torch.clamp(n - 1.0, min=1.0)
                rm.copy_(torch.where(ok, 0.9 * rm + 0.1 * mean.detach(), rm))
                rv.copy_(torch.where(ok, 0.9 * rv + 0.1 * unbiased, rv))
        return torch.where(n > 1.0, out, x)

    def dense(self, name, x, bias=True):
        """x [..., d] @ kernel [d, f] (+ bias)."""
        y = self.p.ein("...d,df->...f", x, self.P[name + ".kernel"])
        return y + self.P[name + ".bias"] if bias else y

    def stacked(self, name, x, bias=True):
        """n parallel linears: x [B, d] (shared) or [B, n, d] -> [B, n, f]."""
        k = self.P[name + ".kernel"]
        eq = "bd,ndf->bnf" if x.dim() == 2 else "bnd,ndf->bnf"
        y = self.p.ein(eq, x, k)
        return y + self.P[name + ".bias"] if bias else y

    def mlp(self, name, x, n_layers, out=False, gate=None):
        for i in range(n_layers):
            x = self.stacked(f"{name}.linear_{i}", x)
            x = self.dropout(torch.relu(self.bn(f"{name}.bn_{i}", x, gate)))
        return self.stacked(f"{name}.out", x) if out else x

    # -------------------------------------------------------- embedding
    def embed(self, x, rows=None):
        """(pooled embeddings [B, F, D], the gathered f32 rows [B, C, D]).
        ``rows``: the rows to use (a grad leaf), else gathered here."""
        cfg = self.cfg
        if rows is None:
            rows = self.gather(x)
        n1 = len(cfg["one_hot_dims"])
        B, D = rows.shape[0], rows.shape[-1]
        seq = rows[:, n1:, :].reshape(B, cfg["n_seq_fields"],
                                      cfg["seq_maxlen"], D).mean(dim=2)
        return torch.cat([rows[:, :n1, :], seq], dim=1), rows

    def row_ids(self, x):
        cfg = self.cfg
        dims = torch.tensor(cfg["one_hot_dims"], dtype=torch.int64,
                            device=x.device)
        off = torch.cumsum(dims, 0) - dims
        seq = off[cfg["itemid_idx"]].repeat(cfg["n_seq_fields"]
                                            * cfg["seq_maxlen"])
        off = torch.cat([off, seq])
        n_rows = self.P["embedding.table"].shape[0]
        return torch.clamp(x.to(torch.int64) + off, 0, n_rows - 1)

    def gather(self, x):
        return self.P["embedding.table"][self.row_ids(x)].to(F32)

    def cross(self, flat):
        x = flat
        for i in range(self.cfg["n_cross_layers"]):
            x = flat * self.p.ein("bd,df->bf", x, self.P[f"cn.w_{i}"]) \
                + self.P[f"cn.b_{i}"] + x
        return x


# ---------------------------------------------------------------- losses
def bce_logits(logit, y):
    return (torch.clamp(logit, min=0.0) - logit * y
            + torch.log1p(torch.exp(-torch.abs(logit))))


def reg_loss(rules: Sequence[str], P: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
    """The dense L2 of the leaves that ``rules`` match."""
    pats = [re.compile(r) for r in rules]
    total = torch.zeros((), device=P["linear.kernel"].device)
    for name, t in P.items():
        if is_buffer(name):
            continue
        if any(r.search(name.replace(".", "/")) for r in pats):
            total = total + REG_L2 * torch.sum(torch.square(t))
    return total
