"""The plain reference of the Multiverse model in float32 PyTorch.

Written from the model's equations (Liang et al., CVPR 2020; the
layouts of the port's parameter tree): a strided 3x3 scene CNN, ConvLSTM
encoders and decoders with tf.contrib's gate order and a forget bias of
1, the nine-neighbour graph attention on the class decoder's hidden
state and a 3x3 hidden-to-grid readout, as the decode runs them. It
imports nothing of the program and takes no weights or tables that the
program made: the benchmark hands both sides the same seeded weights
and inputs. No kernels, no cache, no batching tricks.

Activations are NHWC and kernels HWIO, as the program's tree holds them;
SAME padding puts the odd element after, as XLA does. ``quant`` (a
function) is applied to both operands of every conv and of the graph
attention's products: the control computes the reference at a lower
precision through it (:func:`fp8`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
FORGET_BIAS = 1.0


def no_tf32() -> None:
    """Full float32 products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at a per-tensor scale (its absolute max
    at 448), back in float32."""
    amax = x.detach().abs().amax().clamp_min(1e-12)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s


def _pad(size: int, kernel: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
         stride: int = 1, act: bool = False, quant: Quant = None
         ) -> torch.Tensor:
    """SAME conv of NHWC ``x`` with HWIO ``w`` (+ b, then tanh)."""
    if quant is not None:
        x, w = quant(x), quant(w)
    xt = x.permute(0, 3, 1, 2)
    ph = _pad(xt.shape[2], w.shape[0], stride)
    pw = _pad(xt.shape[3], w.shape[1], stride)
    xt = F.pad(xt, (*pw, *ph))
    out = F.conv2d(xt, w.permute(3, 2, 0, 1), stride=stride)
    out = out.permute(0, 2, 3, 1)
    if b is not None:
        out = out + b
    return torch.tanh(out) if act else out


def lstm_step(p: Dict[str, torch.Tensor], x, c, h, quant: Quant = None):
    """One ConvLSTM step; returns (c', h')."""
    gates = conv(torch.cat([x, h], dim=-1), p["kernel"], p["bias"],
                 quant=quant)
    i, g, f, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f + FORGET_BIAS) * c + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.tanh(c) * torch.sigmoid(o)


def gnn(h: torch.Tensor, scene: Optional[torch.Tensor],
        quant: Quant = None) -> torch.Tensor:
    """Attention over each cell's 3x3 neighbourhood (itself included,
    only cells inside the grid): weights the softmax of the cosine
    similarities of [h, scene] rows, the update the weighted sum of the
    neighbours' h."""
    N, H, W, D = h.shape
    node = h if scene is None else torch.cat([h, scene], dim=-1)
    node = node / torch.sqrt(torch.clamp_min(
        torch.sum(node * node, dim=-1, keepdim=True), 1e-12))
    states = h
    if quant is not None:
        node, states = quant(node), quant(states)
    node_p = F.pad(node, (0, 0, 1, 1, 1, 1))
    states_p = F.pad(states, (0, 0, 1, 1, 1, 1))
    ys = torch.arange(H, device=h.device)[:, None]
    xs = torch.arange(W, device=h.device)[None, :]
    sims, neigh = [], []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = node_p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            inside = ((ys + dy >= 0) & (ys + dy < H) & (xs + dx >= 0)
                      & (xs + dx < W))
            s = torch.sum(node * nb, dim=-1)
            sims.append(torch.where(inside, s, torch.full_like(s, -1e30)))
            neigh.append(states_p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
    attn = torch.softmax(torch.stack(sims, dim=-1), dim=-1)
    if quant is not None:
        attn = quant(attn)
    return sum(attn[..., j:j + 1] * neigh[j] for j in range(9))


def one_hot(ids: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Flat cell ids [...] -> [..., h, w, 1] f32."""
    return F.one_hot(ids.long(), h * w).float().reshape(
        tuple(ids.shape) + (h, w, 1))


class Model:
    """The reference over a weights dict {dotted name: tensor} and the
    configuration's sizes (a dict of the configuration's fields)."""

    def __init__(self, weights: Dict[str, torch.Tensor], model: dict,
                 quant: Quant = None):
        self.w = weights
        self.m = model
        self.quant = quant
        s = [i for i, u in enumerate(model["use_grids"]) if u]
        if len(s) != 1 or model.get("soft_grid", 1) != 1:
            raise ValueError("the reference runs one grid scale and the "
                             "soft-grid kernel 1")
        self.scale = s[0]
        st = model["scene_grid_strides"][self.scale]
        self.h = int(round(model["scene_h"] / st))
        self.w_ = int(round(model["scene_w"] / st))

    def p(self, name: str) -> Dict[str, torch.Tensor]:
        pre = name + "."
        return {k[len(pre):]: v for k, v in self.w.items()
                if k.startswith(pre)}

    def sp(self, name: str) -> Dict[str, torch.Tensor]:
        return self.p("scales.%d.%s" % (self.scale, name))

    # ------------------------------------------------------------ encode
    def scene(self, maps: torch.Tensor) -> torch.Tensor:
        """One-hot maps [N, T, SH, SW, C] -> the active scale's scene
        features [N, T, h, w, Cs]."""
        N, T = maps.shape[:2]
        x = maps.reshape((N * T,) + tuple(maps.shape[2:])).float()
        if self.m.get("norm_input"):
            x = x * 2.0 - 1.0
        for i in range(self.scale + 1):
            p = self.p("scene_conv%d" % (i + 1))
            x = conv(x, p["w"], p["b"], stride=2, act=True, quant=self.quant)
        return x.reshape((N, T) + tuple(x.shape[1:]))

    def scan(self, p, xs: torch.Tensor):
        N, T = xs.shape[:2]
        D = p["bias"].shape[0] // 4
        c = xs.new_zeros((N, self.h, self.w_, D))
        h = xs.new_zeros((N, self.h, self.w_, D))
        for t in range(T):
            c, h = lstm_step(p, xs[:, t], c, h, self.quant)
        return c, h

    def encode(self, obs_class: torch.Tensor, obs_target: torch.Tensor,
               maps: torch.Tensor):
        """obs_class [N, T_obs] cell ids of the active scale, obs_target
        [N, T_obs, h, w, 2], maps [N, T_obs, SH, SW, C]. Returns the
        class encoder's (c, h), the regression encoder's (c, h) and the
        time-averaged scene features [N, h, w, Cs]."""
        onehot = one_hot(obs_class, self.h, self.w_)
        scene = self.scene(maps)
        enc = self.scan(self.sp("enc_class"), scene * onehot)
        enc_reg = self.scan(self.sp("enc_reg"), obs_target)
        return enc, enc_reg, scene.mean(dim=1)

    # ------------------------------------------------------------ decode
    def emb_table(self) -> torch.Tensor:
        """The class decoder's embedding of every cell's one-hot map,
        [HW, h, w, E]."""
        HW = self.h * self.w_
        p = self.sp("dec_class_emb")
        basis = one_hot(torch.arange(HW, device=p["w"].device), self.h,
                        self.w_)
        return conv(basis, p["w"], p["b"], act=True, quant=self.quant)

    def class_step(self, emb, c, h, scene_mean):
        """GNN residual on h, the cell, the readout: (c', h', logits
        [N, HW])."""
        if self.m["use_gnn"]:
            h = h + gnn(h, scene_mean, self.quant)
        c, h = lstm_step(self.sp("dec_class"), emb, c, h, self.quant)
        logits = conv(h, self.sp("h2g_class")["w"], quant=self.quant)
        return c, h, logits.reshape(h.shape[0], -1)

    def class_paths(self, enc, scene_mean, first_ids, paths):
        """Teacher-forced class decode along given cell paths. enc: the
        class encoder's (c, h) [N, ...]; first_ids [N] the last observed
        cell; paths [N, P, T] ids. Step t reads the embedding of the
        path's cell t - 1 (the first id at t = 0). Returns logits
        [N, P, T, HW]."""
        N, P, T = paths.shape
        table = self.emb_table()

        def rep(x):
            return x[:, None].expand((N, P) + tuple(x.shape[1:])).reshape(
                (N * P,) + tuple(x.shape[1:]))

        c, h = rep(enc[0]), rep(enc[1])
        scene = rep(scene_mean)
        prev = rep(first_ids)
        out = []
        for t in range(T):
            c, h, logits = self.class_step(table[prev.long()], c, h, scene)
            out.append(logits)
            prev = paths[:, :, t].reshape(-1)
        return torch.stack(out, dim=1).reshape(N, P, T, -1)

    def reg_decode(self, enc_reg, first: torch.Tensor, T: int):
        """Regression decoder fed its own readout: offsets [N, T, h, w,
        2]."""
        emb_p, cell_p = self.sp("dec_reg_emb"), self.sp("dec_reg")
        h2g = self.sp("h2g_reg")["w"]
        c, h = enc_reg
        x = first
        out = []
        for _ in range(T):
            emb = conv(x, emb_p["w"], emb_p["b"], act=True, quant=self.quant)
            c, h = lstm_step(cell_p, emb, c, h, self.quant)
            x = conv(h, h2g, quant=self.quant)
            out.append(x)
        return torch.stack(out, dim=1)
