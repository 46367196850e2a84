"""Public model facade: init / loss / grad_fn and the serving surface,
init_caches / encode / decode_step (repro/models/model.py)."""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import engine
from repro_torch.models import transformer

__all__ = ["Model", "build_model"]


def _leaves(tree):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key])
        else:
            yield tree[key]


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
        SSD and RG-LRU kernels (#15–#17), forward only (MLA and MoE layers
        have none).  The MoE aux loss is :meth:`loss`'s."""
        return transformer.forward(params, batch, self.cfg, impl)[0]

    def loss(self, params: dict, batch: dict, *,
             impl: str = "xla") -> torch.Tensor:
        """Next-token cross entropy, lse(logits) − logits[target] with a
        stop-gradient max and f32 reductions (the reference's form), plus
        ``router_aux_weight`` times the MoE aux loss of an MoE config."""
        logits, aux, _ = transformer.forward(params, batch, self.cfg, impl)
        targets = batch["tokens"][:, 1:]
        lg = logits[:, :-1]
        m = lg.max(dim=-1, keepdim=True).values.detach()
        sumexp = torch.exp((lg - m).float()).sum(dim=-1)
        lse = torch.log(sumexp) + m[..., 0].float()
        gold = torch.gather(lg, -1, targets[..., None])[..., 0].float()
        nll = lse - gold                                    # (B, S-1)
        loss = nll.sum() / max(nll.numel(), 1)
        if self.cfg.moe is not None:
            loss = loss + self.cfg.moe.router_aux_weight * aux
        return loss

    def grad_fn(self, *, impl: str = "xla"):
        """One agent's (params, batch) -> (loss, grads), grads in params'
        layout: ``torch.func.grad_and_value`` of :meth:`loss`, so that the
        engines can vmap it over every agent row at once
        (core/engine.py:GradFn; the reference's PRNG key is dropped).
        The kernels have no backward: with ``impl='pallas'`` the first
        kernel wrapper the forward reaches raises (a model whose forward
        reaches none, DeepSeek-V2-Lite's MLA and MoE, runs the plain
        path).  The reference
        rematerialises each block's activations in the backward
        (``remat``), which saves memory and changes no number; the port
        keeps the activations (torch.utils.checkpoint does not compose
        with the torch.func transforms)."""
        return engine.value_and_grad(
            functools.partial(self.loss, impl=impl))


    # ---- serving ---------------------------------------------------------
    def init_caches(self, batch: int, cache_len: int, *,
                    long_variant: bool = False, dtype=torch.bfloat16,
                    device) -> dict:
        """Empty decode caches on ``device``; KV caches in ``dtype``."""
        return transformer.init_decode_caches(
            self.cfg, batch, cache_len, long_variant=long_variant,
            dtype=dtype, device=device)

    def encode(self, params: dict, batch: dict) -> None:
        """Encoder memory of an encoder-decoder config: every ported
        config is decoder-only, so there is none."""
        del params, batch
        return None

    def decode_step(self, params: dict, batch: dict, caches: dict, *,
                    enc_out=None, long_variant: bool = False):
        """One-token decode, batch {'tokens' (B, 1), 'positions' (B, 1)}.

        Returns (logits (B, 1, V), new caches).  Runs the plain path; it
        reads nothing back to the host, so it runs under
        ``torch.func.vmap``."""
        if enc_out is not None or self.cfg.rope_kind == "mrope":
            raise NotImplementedError(
                "encoder-decoder and M-RoPE decode are not ported to "
                "repro_torch yet (ROADMAP.md Queue A item 5b)")
        logits, _, new_caches = transformer.forward(
            params, batch, self.cfg, caches=caches,
            long_variant=long_variant)
        return logits, new_caches


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)
