"""The plain reference of the disentangled SND-VAE: forward, ELBO and Adam in
plain PyTorch, written from the model's equations (Guo, Du and Zhao, "Deep
Generative Models for Spatial Networks", KDD'21; the authors' TF1 code,
github.com/xguo7/SND-VAE, ``model.py`` and ``layers.py``).  It imports nothing
of the program and takes nothing the program made: the benchmark hands it the
same inputs and initial weights it hands the program.

Parameters are one flat dict ``{name: tensor}`` under the names of
``param_spec`` (the flax tree's names, which the port keeps).  Layouts: maps
are [B, N, ..., C]; 1-D conv kernels are torch's [out, in, k]; the edge-to-edge
kernel is [O, C, 1, k].  Parity mode: batch norm frozen at its initial
statistics (y = γ·x/√(1 + 1e-3) + β).

The motif convs compute the reference's motif sums (layers.py:143-359) in the
factored rank-R form: level 3 of the third-order conv and levels 4 and 3 of
the fourth-order conv contract the mask against the R-channel inputs before
the R -> h matmuls.  Only sums are reassociated; the tests hold both against
the literal O(N^3) / O(N^4) formulas at small sizes.  Products run in the
inputs' dtype; ``tf32`` in ``set_precision`` lets the control compute them in
TF32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

LEAK = 0.2
BN_EPS = 1e-3


def set_precision(tf32: bool) -> None:
    """Full f32 products (the configurations' precision), or TF32 (the
    control's).  Process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def lrelu(x):
    return torch.maximum(x, LEAK * x)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def conv_out(length: int, stride: int) -> int:
    return -(-length // stride)


def param_spec(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter, in a fixed order.  init is one
    of normal (σ 0.02), truncated (σ 0.02, at most 2σ), glorot, zeros, ones."""
    enc, dec = cfg["encoder"], cfg["decoder"]
    N, nf, D, R = cfg["num_nodes"], cfg["num_features"], cfg["spatial_dim"], cfg["rel_dim"]
    spec: List[Tuple[str, tuple, str]] = []

    def norm(name, c):
        spec.extend([(f"{name}.gamma", (c,), "ones"), (f"{name}.beta", (c,), "zeros")])

    def dense(name, i, o):
        spec.extend([(f"{name}.kernel", (i, o), "normal"), (f"{name}.bias", (o,), "zeros")])

    def conv1d(name, i, o, k):
        spec.extend([(f"{name}.kernel", (o, i, k), "glorot"), (f"{name}.bias", (o,), "zeros")])

    c = nf
    for i, h in enumerate(enc["g_conv_hidden"]):
        spec.append((f"g_convs.{i}.kernel", (c, h), "truncated"))
        norm(f"g_bns.{i}", h)
        c = h + nf
    norm("encoder_g_bn", c)
    dense("g_lin1", N * c, enc["g_hidden_size"])
    dense("g_lin_mean", enc["g_hidden_size"], enc["g_latent_size"])
    dense("g_lin_std", enc["g_hidden_size"], enc["g_latent_size"])

    c, L = D, N
    for i, (ch, k, s) in enumerate(zip(enc["s_channels"], enc["s_kernel_sizes"],
                                       enc["s_strides"])):
        conv1d(f"s_convs.{i}", c, ch, k)
        norm(f"s_bns.{i}", ch)
        c, L = ch, conv_out(L, s)
    norm("encoder_s_bn", c)
    dense("s_lin1", L * c, enc["s_hidden_size"])
    dense("s_lin_mean", enc["s_hidden_size"], enc["s_latent_size"])
    dense("s_lin_std", enc["s_hidden_size"], enc["s_latent_size"])

    c = nf
    for i, hidden in enumerate(enc["sg_conv_hidden"]):
        Fi = c
        if len(hidden) == 3:
            h0, h1, h2 = hidden
            shapes = (("Matrix1", (3 * Fi + 3 * R, h0)), ("bias1", (h0,)),
                      ("Matrix2", (2 * Fi + R + h0, h1)), ("bias2", (h1,)),
                      ("Matrix3", (Fi + h1, h2)), ("bias3", (h2,)))
        else:
            h0, h1, h2, h3 = hidden
            shapes = (("Matrix0", (4 * Fi + 5 * R, h0)), ("bias0", (h0,)),
                      ("Matrix1", (3 * Fi + 3 * R + h0, h1)), ("bias1", (h1,)),
                      ("Matrix2", (2 * Fi + R + h1, h2)), ("bias2", (h2,)),
                      ("Matrix3", (Fi + h2, h3)), ("bias3", (h3,)))
        for name, shape in shapes:
            spec.append((f"sg_convs.{i}.{name}", shape,
                         "normal" if name.startswith("Matrix") else "zeros"))
        c = hidden[-1]
        norm(f"sg_bns.{i}", c)
    norm("encoder_sg_bn", c)
    dense("sg_lin1", N * c, enc["sg_hidden_size"])
    dense("sg_lin_mean", enc["sg_hidden_size"], enc["sg_latent_size"])
    dense("sg_lin_std", enc["sg_hidden_size"], enc["sg_latent_size"])

    nh = dec["node_h_size"]
    dense("d_sg_lin1", enc["sg_latent_size"], N * nh)
    dense("d_s_lin1", enc["s_latent_size"], N * nh)
    dense("d_g_lin1", enc["g_latent_size"], N * nh)
    c = 2 * nh
    for i, (ch, k) in enumerate(zip(dec["n_d_channels"], dec["n_d_kernel_sizes"])):
        conv1d(f"n_deconvs.{i}", c, ch, k)
        norm(f"d_bn_n.{i}", ch)
        c = ch
    norm("decoder_node_bn", c)
    dense("d_n_lin2", c, nf)
    c = 4 * nh
    for i, h in enumerate(dec["e_d_hidden"]):
        spec.extend([(f"e_deconvs.{i}.w1", (h, c, 1, N), "truncated"),
                     (f"e_deconvs.{i}.biases1", (h,), "zeros")])
        norm(f"d_bn_e.{i}", c)
        c = h
    norm("decoder_adj_bn", c)
    dense("d_e_lin2", c, 2)
    c = 2 * nh
    for i, (ch, k) in enumerate(zip(dec["s_d_channels"], dec["s_d_kernel_sizes"])):
        conv1d(f"s_deconvs.{i}", c, ch, k)
        norm(f"d_bn_s.{i}", ch)
        c = ch
    dense("d_s_lin2", c, D)
    return spec


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def bn(P, name, x):
    return x * (P[f"{name}.gamma"] / math.sqrt(1.0 + BN_EPS)) + P[f"{name}.beta"]


def dense(P, name, x):
    return x @ P[f"{name}.kernel"] + P[f"{name}.bias"]


def same_pad(length: int, k: int, stride: int = 1) -> Tuple[int, int]:
    total = max((conv_out(length, stride) - 1) * stride + k - length, 0)
    return total // 2, total - total // 2


def conv1d(P, name, x, stride: int = 1):
    """SAME 1-D conv of an NWC map [B, L, C]."""
    w = P[f"{name}.kernel"]
    xc = F.pad(x.transpose(1, 2), same_pad(x.shape[1], w.shape[-1], stride))
    return F.conv1d(xc, w, P[f"{name}.bias"], stride=stride).transpose(1, 2)


def graph_conv(adj, x, w):
    return lrelu(adj @ (x @ w))


def motif3(adj, x, rel, P, pre):
    """Third-order spatial-motif conv (layers.py:143-198), factored."""
    Fi, R = x.shape[-1], rel.shape[-1]
    m1, b1 = P[pre + "Matrix1"], P[pre + "bias1"]
    m2, b2 = P[pre + "Matrix2"], P[pre + "bias2"]
    m3, b3 = P[pre + "Matrix3"], P[pre + "bias3"]
    px, pr = lrelu(x), lrelu(rel)
    deg = adj.sum(-1)
    nx = torch.einsum("bjk,bkf->bjf", adj, px)
    nr = torch.einsum("bjk,bjkr->bjr", adj, pr)
    # level 3: m3[i,j] = Σ_k A[j,k]·(M1 [x_i, x_j, x_k, r_ij, r_jk, r_ik] + b1)
    a_i = px @ m1[:Fi]
    v_j = deg[..., None] * (px @ m1[Fi:2 * Fi]) + nx @ m1[2 * Fi:3 * Fi] \
        + nr @ m1[3 * Fi + R:3 * Fi + 2 * R]
    rf = torch.einsum("bjk,bikr->bijr", adj, pr)                    # Σ_k A[j,k]·r_ik
    m3s = deg[:, None, :, None] * (a_i[:, :, None] + b1 + pr @ m1[3 * Fi:3 * Fi + R]) \
        + v_j[:, None] + rf @ m1[3 * Fi + 2 * R:]
    nt = torch.einsum("bij,bijh->bih", adj, lrelu(adj[..., None] * m3s))
    # level 2: Σ_j A[i,j]·(M2 [x_i, x_j, r_ij, m3[i,j]] + b2), then level 1
    m2s = deg[..., None] * (px @ m2[:Fi] + b2) + nx @ m2[Fi:2 * Fi] \
        + nr @ m2[2 * Fi:2 * Fi + R] + nt @ m2[2 * Fi + R:]
    return px @ m3[:Fi] + lrelu(m2s) @ m3[Fi:] + b3


def motif4(adj, x, rel, P, pre):
    """Fourth-order spatial-motif conv (layers.py:200-277), factored; the skip
    distances are ``rel`` too."""
    Fi, R = x.shape[-1], rel.shape[-1]
    m0, b0 = P[pre + "Matrix0"], P[pre + "bias0"]
    m1, b1 = P[pre + "Matrix1"], P[pre + "bias1"]
    m2, b2 = P[pre + "Matrix2"], P[pre + "bias2"]
    m3, b3 = P[pre + "Matrix3"], P[pre + "bias3"]
    cols = lambda m, widths: torch.split(m, list(widths) + [m.shape[0] - sum(widths)])
    # Matrix0 rows: x_i, x_j, x_k, x_p, r_ij, r_jk, r_kp, d_ik, d_ip
    w_a, w_b, w_c, w_p, w_u, w_v, w_w, w_y, w_z, _ = cols(m0, (Fi,) * 4 + (R,) * 5)
    # Matrix1 rows: x_i, x_j, x_k, r_ij, r_jk, d_ik, m4[i,j,k]
    c_i, c_j, c_k, g_ij, g_jk, g_ik, w_m4 = cols(m1, (Fi,) * 3 + (R,) * 3)
    px, pr = lrelu(x), lrelu(rel)
    deg = adj.sum(-1)
    mx = torch.einsum("bkp,bpf->bkf", adj, px)                      # Σ_p A[k,p]·x_p
    nr = torch.einsum("bkp,bkpr->bkr", adj, pr)                     # Σ_p A[k,p]·r_kp
    nd = torch.einsum("bkp,bipr->bikr", adj, pr)                    # Σ_p A[k,p]·d_ip
    # level 4: m4[i,j,k] = Σ_p A[k,p]·(M0 [...] + b0), for A[i,j]·A[j,k] != 0
    a_i, a_j = px @ w_a, px @ w_b
    alpha = deg[:, None, :, None] * (a_i[:, :, None] + pr @ w_y) + nd @ w_z     # [B,i,k,h0]
    beta = deg[:, None, :, None] * (a_j[:, :, None] + pr @ w_v)                # [B,j,k,h0]
    gamma = deg[..., None] * (px @ w_c + b0) + mx @ w_p + nr @ w_w             # [B,k,h0]
    # the [B,i,j,k,h0] sum is built in one buffer, updated in place, so that
    # autograd keeps one such tensor (lrelu's output)
    m4 = deg[:, None, None, :, None] * (pr @ w_u)[:, :, :, None, :]
    m4 += alpha[:, :, None]
    m4 += beta[:, None]
    m4 += gamma[:, None, None]
    m4 *= (adj[:, :, :, None] * adj[:, None])[..., None]
    F.leaky_relu_(m4, LEAK)
    # level 3: m3[i,j] = Σ_k A[j,k]·(M1 [x_i, x_j, x_k, r_ij, r_jk, d_ik, m4] + b1)
    tm = torch.matmul(adj[:, None, :, None, :], m4).squeeze(-2)                # [B,i,j,h0]
    m3s = deg[:, None, :, None] * ((px @ c_i)[:, :, None] + (px @ c_j)[:, None]
                                   + pr @ g_ij + b1) \
        + (mx @ c_k + nr @ g_jk)[:, None] + nd @ g_ik + tm @ w_m4
    nt = torch.einsum("bij,bijh->bih", adj, lrelu(adj[..., None] * m3s))
    p2, q2, s2, t2 = cols(m2, (Fi, Fi, R))
    m2s = deg[..., None] * (px @ p2 + b2) + mx @ q2 + nr @ s2 + nt @ t2
    return px @ m3[:Fi] + lrelu(m2s) @ m3[Fi:] + b3


def e2e(P, name, x):
    """Edge-to-edge conv of [B,N,N,C]: a 1 x N SAME conv along rows plus its
    transpose along columns, one bias added to each."""
    w, b = P[f"{name}.w1"], P[f"{name}.biases1"]
    xc = x.permute(0, 3, 1, 2)
    H, W, k = xc.shape[2], xc.shape[3], w.shape[-1]
    row = F.conv2d(F.pad(xc, same_pad(W, k)), w, b)
    col = F.conv2d(F.pad(xc, (0, 0) + same_pad(H, k)), w.transpose(2, 3), b)
    return (row + col).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def encode(P, cfg, batch) -> Dict[str, torch.Tensor]:
    enc = cfg["encoder"]
    adj, feats, coords, rel, trees = (batch[k] for k in
                                      ("adj", "features", "coords", "rel", "adj_samples"))
    B, N = adj.shape[:2]
    S = trees.shape[1]
    g = feats
    for i in range(len(enc["g_conv_hidden"])):
        g = torch.cat([bn(P, f"g_bns.{i}", graph_conv(adj, g, P[f"g_convs.{i}.kernel"])),
                       feats], dim=-1)
    g = dense(P, "g_lin1", bn(P, "encoder_g_bn", g).reshape(B, -1))
    h = coords
    for i, s in enumerate(enc["s_strides"]):
        h = torch.relu(bn(P, f"s_bns.{i}", conv1d(P, f"s_convs.{i}", h, s)))
    h = dense(P, "s_lin1", bn(P, "encoder_s_bn", h).reshape(B, -1))
    adj_s = trees.reshape(B * S, N, N)
    rel_s = rel[:, None].expand((B, S) + rel.shape[1:]).reshape((B * S,) + rel.shape[1:])
    sg = feats[:, None].expand((B, S) + feats.shape[1:]).reshape(B * S, N, -1)
    for i, hidden in enumerate(enc["sg_conv_hidden"]):
        conv = motif3 if len(hidden) == 3 else motif4
        sg = lrelu(bn(P, f"sg_bns.{i}", conv(adj_s, sg, rel_s, P, f"sg_convs.{i}.")))
    sg = dense(P, "sg_lin1", bn(P, "encoder_sg_bn", sg).reshape(B * S, -1))
    return {"mean_sg": dense(P, "sg_lin_mean", sg).reshape(B, S, -1),
            "logstd_sg": dense(P, "sg_lin_std", sg).reshape(B, S, -1),
            "mean_s": dense(P, "s_lin_mean", h), "logstd_s": dense(P, "s_lin_std", h),
            "mean_g": dense(P, "g_lin_mean", g), "logstd_g": dense(P, "g_lin_std", g)}


def decode(P, cfg, z_sg, z_s, z_g) -> Dict[str, torch.Tensor]:
    dec = cfg["decoder"]
    N, nh = cfg["num_nodes"], dec["node_h_size"]
    B, S = z_sg.shape[:2]
    zsg = dense(P, "d_sg_lin1", z_sg.reshape(B * S, -1)).reshape(B, S, N, nh).mean(dim=1)
    zs = dense(P, "d_s_lin1", z_s).reshape(B, N, nh)
    zg = dense(P, "d_g_lin1", z_g).reshape(B, N, nh)
    hg = torch.cat([zsg, zg], dim=-1)
    x = hg
    for i in range(len(dec["n_d_channels"])):
        x = bn(P, f"d_bn_n.{i}", conv1d(P, f"n_deconvs.{i}", x))
    node_feat = torch.sigmoid(dense(P, "d_n_lin2", bn(P, "decoder_node_bn", x)))
    sp = torch.cat([zsg, zs], dim=-1)
    for i in range(len(dec["s_d_channels"])):
        sp = bn(P, f"d_bn_s.{i}", conv1d(P, f"s_deconvs.{i}", sp))
    coords = torch.sigmoid(dense(P, "d_s_lin2", sp))
    C = hg.shape[-1]
    t = torch.cat([hg[:, :, None].expand(B, N, N, C), hg[:, None].expand(B, N, N, C)], dim=-1)
    for i in range(len(dec["e_d_hidden"])):
        t = e2e(P, f"e_deconvs.{i}", torch.relu(bn(P, f"d_bn_e.{i}", t)))
    logits = dense(P, "d_e_lin2", torch.relu(bn(P, "decoder_adj_bn", t)))
    # the diagonal is forced to "no edge": logits (1, 0)
    off = 1.0 - torch.eye(N, dtype=logits.dtype, device=logits.device)
    adj_prob = torch.stack([off * logits[..., 0] + (1.0 - off), off * logits[..., 1]], dim=-1)
    return {"adj_prob": adj_prob, "coords": coords, "node_feat": node_feat}


def normal_draws(gen: torch.Generator, B: int, S: int, cfg: dict, dtype=torch.float32):
    """ε (or prior z) in the order s, sg, g, as the program draws it."""
    enc = cfg["encoder"]
    dev = gen.device
    z_s = torch.randn((B, enc["s_latent_size"]), generator=gen, device=dev, dtype=dtype)
    z_sg = torch.randn((B, S, enc["sg_latent_size"]), generator=gen, device=dev, dtype=dtype)
    z_g = torch.randn((B, enc["g_latent_size"]), generator=gen, device=dev, dtype=dtype)
    return z_sg, z_s, z_g


def forward(P, cfg, batch, gen: Optional[torch.Generator] = None):
    """Encode and decode: posterior means without ``gen``, else z = μ + ε·σ
    with ε drawn from ``gen``."""
    st = encode(P, cfg, batch)
    if gen is None:
        z = (st["mean_sg"], st["mean_s"], st["mean_g"])
    else:
        B, S = st["mean_sg"].shape[:2]
        e_sg, e_s, e_g = normal_draws(gen, B, S, cfg)
        z = tuple(st[f"mean_{k}"] + e * torch.exp(st[f"logstd_{k}"])
                  for k, e in (("sg", e_sg), ("s", e_s), ("g", e_g)))
    return st, decode(P, cfg, *z)


def kl(mean, logstd):
    return -0.5 * (1.0 + 2.0 * logstd - mean.square() - torch.exp(logstd).square()).mean()


def elbo(cfg, st, out, batch) -> torch.Tensor:
    """Edge cross-entropy + node and coordinate MSE + β·(the three KLs)."""
    a = batch["adj"]
    labels = torch.stack([1.0 - a, a], dim=-1)
    adj_loss = -(labels * torch.log_softmax(out["adj_prob"], dim=-1)).sum(-1).mean()
    node_loss = (batch["features"] - out["node_feat"]).square().mean()
    spatial_loss = (batch["coords"] - out["coords"]).square().mean()
    kls = sum(kl(st[f"mean_{k}"], st[f"logstd_{k}"]) for k in ("sg", "s", "g"))
    return adj_loss + node_loss + spatial_loss + cfg["loss"]["beta"] * kls


class Adam:
    """optax.adam: m̂ = m/(1 - b1^t), v̂ = v/(1 - b2^t), w -= lr·m̂/(√v̂ + eps)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads) -> None:
        self.t += 1
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            m_hat = self.m[k] / (1 - self.b1 ** self.t)
            v_hat = self.v[k] / (1 - self.b2 ** self.t)
            params[k].sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))


def train_steps(P0, cfg, batches, gen: torch.Generator) -> dict:
    """One Adam step from ``P0`` on each of ``batches`` in turn, ε from
    ``gen``; returns the losses and their mean, the first step's gradients,
    the first moments m / (1 - b1^t) after the last step, and the
    parameters after it."""
    P = {k: v.detach().clone() for k, v in P0.items()}
    opt = Adam(P, cfg["train"]["learning_rate"])
    losses, first = [], None
    for b in batches:
        leaves = {k: v.requires_grad_(True) for k, v in P.items()}
        st, out = forward(leaves, cfg, b, gen)
        loss = elbo(cfg, st, out, b)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        for v in P.values():
            v.requires_grad_(False)
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(P, grads)
    moments = {k: m / (1 - opt.b1 ** opt.t) for k, m in opt.m.items()}
    return {"losses": losses, "loss": sum(losses) / len(losses), "grads": first,
            "moments": moments, "params": P}
