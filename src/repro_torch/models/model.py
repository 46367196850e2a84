"""Public model facade: init / loss / grad_fn (repro/models/model.py)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer

__all__ = ["Model", "build_model"]


def _leaves(tree):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key])
        else:
            yield tree[key]


def _rebuild(tree, it):
    return {k: _rebuild(v, it) if isinstance(v, dict) else next(it)
            for k, v in sorted(tree.items())}


@dataclasses.dataclass(frozen=True)
class Model:
    """Bound (config, functions) bundle for one architecture."""

    cfg: ArchConfig

    def init(self, draws) -> dict:
        """Random initial parameters on ``draws.device``."""
        return transformer.init_model(draws, self.cfg)

    def param_count(self, params: dict) -> int:
        return sum(leaf.numel() for leaf in _leaves(params))

    def logits(self, params: dict, batch: dict, *,
               impl: str = "xla") -> torch.Tensor:
        """Prefill logits (B, S, V); ``impl='pallas'`` runs the attention,
        SSD and RG-LRU kernels (#15–#17), forward only."""
        return transformer.forward(params, batch, self.cfg, impl)

    def loss(self, params: dict, batch: dict, *,
             impl: str = "xla") -> torch.Tensor:
        """Next-token cross entropy, lse(logits) − logits[target] with a
        stop-gradient max and f32 reductions (the reference's form)."""
        logits = self.logits(params, batch, impl=impl)
        targets = batch["tokens"][:, 1:]
        lg = logits[:, :-1]
        m = lg.max(dim=-1, keepdim=True).values.detach()
        sumexp = torch.exp((lg - m).float()).sum(dim=-1)
        lse = torch.log(sumexp) + m[..., 0].float()
        gold = torch.gather(lg, -1, targets[..., None])[..., 0].float()
        nll = lse - gold                                    # (B, S-1)
        return nll.sum() / max(nll.numel(), 1)

    def grad_fn(self, *, impl: str = "xla"):
        """(params, batch) -> (loss, grads) with grads in params' layout.
        The kernels have no backward: with ``impl='pallas'`` the first
        kernel wrapper the forward reaches raises."""
        def fn(params, batch):
            leaves = [leaf.detach().requires_grad_()
                      for leaf in _leaves(params)]
            tree = _rebuild(params, iter(leaves))
            with torch.enable_grad():
                loss = self.loss(tree, batch, impl=impl)
                grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), _rebuild(params, iter(grads))
        return fn


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)
