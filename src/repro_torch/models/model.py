"""Public model facade: init / loss / grad_fn and the serving surface,
init_caches / encode / decode_step (repro/models/model.py)."""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import engine
from repro_torch.core.draws import ShapeDraws
from repro_torch.models import transformer
from repro_torch.sharding import tp as tp_lib

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

    def init_shapes(self, device="meta") -> dict:
        """The parameter tree's shapes and dtypes, nothing allocated: the
        port's ``jax.eval_shape(model.init, key)``.  :meth:`init` on
        ``core.draws.ShapeDraws``, whose draws are ``torch.empty``, on the
        meta device by default."""
        return self.init(ShapeDraws(device))

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
        stop-gradient max and f32 reductions (the reference's form),
        averaged over the text targets (a vision config takes no loss at
        target index t < ``frontend_positions``, the patch positions,
        whether or not the batch carries ``frontend_embeds``), plus
        ``router_aux_weight`` times the MoE aux loss of an MoE config.

        Under a model group (a tensor-parallel forward, whose logits are
        this rank's block of the vocabulary) the cross entropy is
        vocabulary-parallel in the same form: the maximum all-reduced
        with MAX, the sum of exponentials and the gold logit (0 on the
        ranks whose block does not hold the target) summed over the group
        with ``tp.reduce_from``, in f32.  Every rank of the group then
        holds the whole loss, once."""
        logits, aux, _ = transformer.forward(params, batch, self.cfg, impl)
        targets = batch["tokens"][:, 1:]
        lg = logits[:, :-1]
        tp = tp_lib.active(self.cfg.tp_axis_name)
        if tp is None or lg.shape[-1] == self.cfg.vocab_size:
            m = lg.max(dim=-1, keepdim=True).values.detach()
            sumexp = torch.exp((lg - m).float()).sum(dim=-1)
            gold = torch.gather(lg, -1, targets[..., None])[..., 0].float()
        else:
            v = lg.shape[-1]
            m = tp_lib.all_reduce_max(
                lg.max(dim=-1, keepdim=True).values, tp)
            sumexp = tp_lib.reduce_from(
                torch.exp((lg - m).float()).sum(dim=-1), tp)
            local = targets - tp.rank * v
            mine = ((local >= 0) & (local < v)).float()
            gold = tp_lib.reduce_from(torch.gather(
                lg, -1, local.clamp(0, v - 1)[..., None])[..., 0].float()
                * mine, tp)
        lse = torch.log(sumexp) + m[..., 0].float()
        nll = lse - gold                                    # (B, S-1)
        if self.cfg.frontend == "vision" and self.cfg.frontend_positions:
            # the reference's (1, S-1) mask: the sum over the batch is
            # divided by one row's count of text targets
            t = torch.arange(targets.shape[1], device=nll.device)
            mask = (t >= self.cfg.frontend_positions).float()[None]
            loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        else:
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

    def encode(self, params: dict, batch: dict):
        """The encoder memory (B, T, d) of an encoder-decoder config from
        the batch's ``enc_embeds``, on the plain path, for the decode
        loop; None for a decoder-only config."""
        if not self.cfg.is_encoder_decoder:
            return None
        return transformer._encode(params, self.cfg, batch, "xla")

    def decode_step(self, params: dict, batch: dict, caches: dict, *,
                    enc_out=None, long_variant: bool = False):
        """One-token decode, batch {'tokens' (B, 1), 'positions' (B, 1)}
        (and 'mrope_positions' (3, B, 1) for an M-RoPE config); an
        encoder-decoder config attends ``enc_out`` (from :meth:`encode`),
        re-projecting its K and V at every step, as the reference does.

        Returns (logits (B, 1, V), new caches).  Runs the plain path; it
        reads nothing back to the host, so it runs under
        ``torch.func.vmap``."""
        logits, _, new_caches = transformer.forward(
            params, batch, self.cfg, caches=caches, enc_out=enc_out,
            long_variant=long_variant)
        return logits, new_caches


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)
