"""Optimizers, learning-rate schedules and the train and eval steps.

The port of ``multiverse_tpu/train/trainer.py``. The four optimizers
reproduce optax's update rules as the JAX package chains them, not
``torch.optim``'s defaults (which place adadelta's and rmsprop's
epsilons and rmsprop's initial mean square differently):

* gradients are clipped by VALUE to +-``clip_gradient_norm`` first
  (``optax.clip``; the reference flag's name notwithstanding);
* adadelta: rho 0.95, eps 1e-8; sgd with momentum 0.9 (trace, not
  Nesterov); adam: b1 0.9, b2 0.999, eps 1e-8 outside the sqrt;
  rmsprop: decay 0.9, eps 1e-10 inside the sqrt, the mean-square slot
  starting at ONES (TF1's default, which the JAX package asks optax for);
* the learning rate init_lr * emb_lr, exponential staircase or cosine,
  is evaluated at the update count before its increment.

The train step updates the parameters and the optimizer slots in place
(the JAX step returns new ones).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from multiverse_torch.config import MultiverseConfig
from multiverse_torch.models import Batch, compute_loss, model_forward

Schedule = Callable[[int], float]


def build_schedule(cfg: MultiverseConfig,
                   train_num_examples: int) -> Schedule:
    """Exponential staircase / cosine decay / constant, as a function of
    the update count (reference: code/pred_models.py:1645-1665)."""
    base = cfg.init_lr * cfg.emb_lr
    if cfg.use_cosine_lr:
        max_steps = max(
            1, int(train_num_examples / cfg.batch_size * cfg.num_epochs))
        return lambda count: base * 0.5 * (
            1 + math.cos(math.pi * min(count, max_steps) / max_steps))
    if cfg.learning_rate_decay is not None:
        decay_steps = max(1, int(
            train_num_examples / cfg.batch_size * cfg.num_epoch_per_decay))
        rate = cfg.learning_rate_decay
        return lambda count: base if count <= 0 else \
            base * rate ** math.floor(count / decay_steps)
    return lambda count: base


class Optimizer:
    """One of the four update rules after clip-by-value. ``init`` makes
    the slots of a ``{name: parameter}`` dict, ``update`` applies one
    step in place."""

    SLOTS = {"adadelta": ("e_g", "e_x"), "momentum": ("trace",),
             "adam": ("mu", "nu"), "rmsprop": ("nu",)}

    def __init__(self, name: str, schedule: Schedule,
                 clip: Optional[float]):
        if name not in self.SLOTS:
            raise ValueError("unknown optimizer %s" % name)
        self.name = name
        self.schedule = schedule
        self.clip = clip

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        # TF1's RMSProp starts its mean square at ones
        fill = 1.0 if self.name == "rmsprop" else 0.0
        state: dict = {"count": 0}
        for slot in self.SLOTS[self.name]:
            state[slot] = {n: torch.full_like(p, fill, dtype=torch.float32)
                           for n, p in params.items()}
        return state

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: dict) -> None:
        count = state["count"]
        lr = self.schedule(count)
        for n, p in params.items():
            g = grads[n].float()
            if self.clip is not None:
                g = torch.clamp(g, -self.clip, self.clip)
            if self.name == "adadelta":
                rho, eps = 0.95, 1e-8
                e_g = (1 - rho) * g ** 2 + rho * state["e_g"][n]
                u = torch.sqrt(state["e_x"][n] + eps) \
                    / torch.sqrt(e_g + eps) * g
                state["e_x"][n] = (1 - rho) * u ** 2 + rho * state["e_x"][n]
                state["e_g"][n] = e_g
            elif self.name == "momentum":
                u = g + 0.9 * state["trace"][n]
                state["trace"][n] = u
            elif self.name == "adam":
                b1, b2, eps = 0.9, 0.999, 1e-8
                mu = (1 - b1) * g + b1 * state["mu"][n]
                nu = (1 - b2) * g ** 2 + b2 * state["nu"][n]
                state["mu"][n], state["nu"][n] = mu, nu
                # optax takes decay ** count in f32
                t = np.float32(count + 1)
                mu_hat = mu / float(1 - np.float32(b1) ** t)
                nu_hat = nu / float(1 - np.float32(b2) ** t)
                u = mu_hat / (torch.sqrt(nu_hat) + eps)
            else:  # rmsprop
                nu = (1 - 0.9) * g ** 2 + 0.9 * state["nu"][n]
                state["nu"][n] = nu
                u = torch.rsqrt(nu + 1e-10) * g
            p.add_((u * -lr).to(p.dtype))
        state["count"] = count + 1


def build_optimizer(cfg: MultiverseConfig,
                    train_num_examples: int) -> Optimizer:
    return Optimizer(cfg.optimizer, build_schedule(cfg, train_num_examples),
                     cfg.clip_gradient_norm)


Tensors = Dict[str, torch.Tensor]


def gradients(model, total: torch.Tensor) -> Tensors:
    """{name: d total / d parameter} over ``model``'s parameters, zeros
    for a parameter the loss does not reach (as JAX's grad gives)."""
    named = list(model.named_parameters())
    grads = torch.autograd.grad(total, [p for _, p in named],
                                allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(named, grads)}


def loss_and_grads(model, batch: Batch, cfg: MultiverseConfig,
                   rng: Optional[int] = None) -> Tuple[Tensors, Tensors]:
    """Train-mode forward, loss and gradients. Returns ({name:
    gradient}, {loss name: detached scalar, "total" included})."""
    out = model_forward(model, batch, cfg, is_train=True, rng=rng)
    total, parts = compute_loss(model, batch, out, cfg)
    parts = {k: v.detach() for k, v in parts.items()}
    parts["total"] = total.detach()
    return gradients(model, total), parts


def make_train_step(cfg: MultiverseConfig, tx: Optimizer):
    """``step(model, opt_state, batch, rng=None) -> losses``: one SGD
    step on a trainable :class:`~multiverse_torch.models.Multiverse`,
    in place. ``rng`` (an int per step) drives dropout when
    ``cfg.keep_prob`` < 1. The returned losses stay on the device."""

    def step(model, opt_state: dict, batch: Batch,
             rng: Optional[int] = None) -> Tensors:
        grads, parts = loss_and_grads(model, batch, cfg, rng)
        tx.update(dict(model.named_parameters()), grads, opt_state)
        return parts

    return step


def make_eval_step(cfg: MultiverseConfig):
    """``step(model, batch) -> (class logits, reg)`` per scale, the
    eval-mode forward under ``torch.inference_mode`` (on the card's bf16
    path its class decode is the fused decode step)."""

    def step(model, batch: Batch):
        with torch.inference_mode():
            out = model_forward(model, batch, cfg, is_train=False)
        return out.class_logits, out.reg_out

    return step
