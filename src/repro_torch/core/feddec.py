"""FedDec — Algorithm 1 on the stacked tree of every agent's parameters
(repro/core/feddec.py).

The tree engine carries the parameters as the model's dict of tensors,
each leaf stacked over the agents to (n_agents, ...).  One step runs
lines 3–12 of Algorithm 1 through the shared body
(:func:`repro_torch.core.engine.build_step_body`):

  1. sample the mixing matrix  W^t ~ 𝒲,
  2. per-agent SGD step        x_i^{t+1/2} = z_i^t − η_t ∇F_i(z_i^t, ξ_i^t),
     the gradients of all agents in one ``torch.func.vmap`` of the
     one-agent GradFn over the stacked dict, the update vmapped over the
     agents (so adamw's count is per agent, (n,));
  3. gossip                    x_i^{t+1}   = Σ_j W^t_ij x_j^{t+1/2},
     leaf by leaf (kernel #1 once per leaf under ``gossip_impl='pallas'``;
     with a codec, the leaf-wise error-feedback exchange);
  4. if (t+1) ∈ ℋ: the server samples K agents with replacement, averages
     and broadcasts — otherwise z_i^{t+1} = x_i^{t+1}.

:func:`make_feddec_step` runs one step per call; :func:`make_feddec_round`
runs the steps of a round as a Python loop over stacked batches (the
reference scans them in one compiled program).  Randomness comes from the
:class:`repro_torch.core.draws.Draws` object passed with every call,
keyed by the carried step counter.  The flat engine (core/flat.py) runs
the same algorithm on one (n, D) buffer; uncompressed, the two end on the
same parameters.

FedAvg is this configuration with 𝒲 = {I} and the W = I fast path
(``gossip_impl='none'``), see :mod:`repro_torch.core.fedavg`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import compress as compress_lib
from repro_torch.core import delta as delta_lib
from repro_torch.core import engine
from repro_torch.core import server as server_lib
from repro_torch.core.fedavg import FedAvgConfig
from repro_torch.core.mixing import MixingDistribution
from repro_torch.tree import tree_map

__all__ = ["FedDecConfig", "FedAvgConfig", "FedState", "init_state",
           "resolve_tree_gossip", "make_feddec_step", "make_feddec_round"]

LrFn = Callable[[int], Any]


@dataclasses.dataclass(frozen=True)
class FedDecConfig:
    """Static configuration of the federated run.

    Attributes:
      mixing: the distribution 𝒲 of mixing matrices (graph + link failures).
      h: server-round period H (ℋ = {t : t ≡ 0 mod H}).
      k: number of devices sampled per server round (with replacement).
      server_enabled: disable to get pure decentralized gossip SGD.
      gossip_impl: how Σ_j W_ij x_j is executed:
        'dense'  — a plain matrix product (one per leaf on the tree engine);
        'none'   — W = I (FedAvg: skip the mix);
        'pallas' — the streaming gossip kernel #1 (kernels/csrc), on the
                   whole buffer or leaf by leaf;
        'sparse' — neighbour-only mix over the graph's edges (the ELL
                   kernel #2 on CUDA, on the whole buffer or leaf by
                   leaf; the plain CSR gather for skewed graphs).
      gossip_compress: the gossip payload's codec with error feedback
        (core/compress.py): none | identity | bf16 | int8 | topk:R.
        Ignored under gossip_impl 'none' (nothing is exchanged).
      delta: the delta parameterization (core/delta.py): none | full |
        topk:K | lowrank:R.  Gossip moves each agent's encoded delta
        against a shared base row through the same error feedback as
        gossip_compress (so the two are mutually exclusive); 'full' is
        lossless, its trajectory that of 'none' bit for bit.  Flat layout,
        one run, one device.
    """

    mixing: MixingDistribution
    h: int = 10
    k: int = 2
    server_enabled: bool = True
    gossip_impl: str = "dense"
    gossip_compress: str = "none"
    delta: str = "none"

    GOSSIP_IMPLS = engine.GOSSIP_IMPLS

    def __post_init__(self):
        if self.h < 1:
            raise ValueError(f"H must be >= 1, got {self.h}")
        if self.k < 1:
            raise ValueError(f"K must be >= 1, got {self.k}")
        compress_lib.parse_compress(self.gossip_compress)  # validate spec
        delta_lib.parse_delta(self.delta)  # validate spec
        if self.delta != "none" and self.gossip_compress != "none":
            raise ValueError(
                "delta and gossip_compress are mutually exclusive: both "
                "route the exchange through the same error-feedback "
                f"residual (got delta={self.delta!r}, "
                f"gossip_compress={self.gossip_compress!r})")
        engine.check_gossip_impl(self.gossip_impl)

    @property
    def n_agents(self) -> int:
        return self.mixing.n


@dataclasses.dataclass
class FedState:
    """The tree engine's carried state: the stacked parameters (a dict of
    tensors, or a tensor, every leaf (n_agents, ...)), the step counter t
    (starts at 1), the stacked optimizer state (sgd: (); momentum: f32
    slots in the parameters' layout; adamw: {'m', 'v', 'count'} with an
    (n,) count) and the compressed-gossip EF residual (the parameters'
    layout, or () without a codec)."""

    params: Any
    step: int
    opt_state: Any = ()
    residual: Any = ()


def init_state(params_single, n_agents: int, dtype=None, optimizer=None,
               compress: str = "none") -> FedState:
    """Replicate one agent's init to all agents: z_i^1 = z^1 ∀i (Alg. 1
    line 1).  Every leaf is real (n, ...) storage, never a broadcast
    view, so the kernels and in-place updates can take it."""
    def rep(leaf):
        leaf = torch.as_tensor(leaf, dtype=dtype)
        return leaf.unsqueeze(0).repeat((n_agents,) + (1,) * leaf.ndim)

    stacked = tree_map(rep, params_single)
    opt_state = ()
    if optimizer is not None:
        opt_state = tree_map(lambda s: s.unsqueeze(0).repeat(
            (n_agents,) + (1,) * s.ndim), optimizer.init(params_single))
    residual = compress_lib.init_residual_tree(
        compress_lib.parse_compress(compress), stacked)
    return FedState(params=stacked, step=1, opt_state=opt_state,
                    residual=residual)


def resolve_tree_gossip(cfg: FedDecConfig) -> Callable:
    """gossip_impl → a (w, stacked tree) mixing fn: the 'tree' layout of
    :func:`repro_torch.core.engine.resolve_gossip`."""
    return engine.resolve_gossip(cfg, "tree")


def _tree_ops(cfg: FedDecConfig, grad_fn: engine.GradFn, lr_fn: LrFn,
              gossip_fn, optimizer, device) -> engine.EngineOps:
    """The tree engine's vtable for the shared Algorithm-1 body
    (repro/core/feddec.py:158-226)."""
    if gossip_fn is None:
        gossip_fn = resolve_tree_gossip(cfg)
    # leaf-wise compressed exchange with error feedback; W = I (impl
    # 'none') exchanges nothing, so there is nothing to compress
    compressor = compress_lib.parse_compress(cfg.gossip_compress) \
        if cfg.gossip_impl != "none" else None
    ef_gossip = None
    if compressor is not None:
        ef_gossip = compress_lib.make_tree_ef_gossip(compressor, gossip_fn,
                                                     cfg.n_agents)

    def update_one(params, grads, opt_state, eta):
        if optimizer is None:  # Alg. 1 line 5: plain SGD
            return tree_map(
                lambda p, g: p - eta.to(p.dtype) * g.to(p.dtype),
                params, grads), opt_state
        return optimizer.update(params, grads, opt_state, eta)

    def local_update(state: FedState, batch: dict, eta):
        # line 4 for every agent in one batched call, the backward on this
        # thread (the flat engine's memory repair, core/flat.py:grads_of)
        with torch.autograd.set_multithreading_enabled(False):
            out = torch.func.vmap(grad_fn)(state.params, batch)
        if not (isinstance(out, tuple) and len(out) == 2):
            raise TypeError("grad_fn must return (loss, grads), an "
                            "engine.GradFn; wrap a loss as "
                            "engine.value_and_grad(loss)")
        losses, grads = out
        x_half, new_opt = torch.func.vmap(
            update_one, in_dims=(0, 0, 0, None))(
            state.params, grads, state.opt_state, eta)
        return losses, x_half, new_opt

    def server(draws, t, x_next):
        if not cfg.server_enabled or (t + 1) % cfg.h:
            return x_next
        return server_lib.server_round(draws, t, x_next, cfg.k)

    def finish(state, z_next, new_opt, new_res, t, losses, eta):
        # the input state is donated, as the flat engine's: updated in
        # place, so the previous tree is freed even while a caller holds it
        state.params, state.step, state.opt_state = z_next, t + 1, new_opt
        state.residual = new_res
        return state, {"loss": losses.mean(), "eta": eta}

    return engine.EngineOps(
        get_step=lambda s: s.step,
        eta_fn=lambda t: torch.as_tensor(lr_fn(t), device=device).reshape(
            ()),
        sample_w=cfg.mixing.make_sampler(device),
        local_update=local_update,
        gossip=gossip_fn,
        get_residual=lambda s: s.residual,
        server=server,
        finish=finish,
        ef_gossip=ef_gossip)


def make_feddec_step(cfg: FedDecConfig, grad_fn: engine.GradFn,
                     lr_fn: LrFn, gossip_fn=None, optimizer=None, *,
                     device):
    """One-iteration executor of the tree engine: step(state, batch, draws)
    -> (FedState, {'loss': mean loss, 'eta': η_t}).

    ``grad_fn`` is one agent's line 4 (engine.GradFn), called once over
    all agents per step; batch leaves lead with the agent dim.
    ``lr_fn(t)`` gives η_t as a number or a tensor; ``device`` is where
    the state lives (W^t is made there).  ``gossip_fn`` overrides the
    resolved mix; ``optimizer`` (default plain SGD) keeps per-agent state
    that is not gossiped.  The state passed in is donated: updated in
    place and returned.  A shim over :func:`engine.make_engine_step`.
    """
    espec = engine.parse_engine_spec(cfg, layout="tree")
    return engine.make_engine_step(espec, grad_fn, lr_fn, device=device,
                                   gossip_fn=gossip_fn, optimizer=optimizer)


def make_feddec_round(cfg: FedDecConfig, grad_fn: engine.GradFn,
                      lr_fn: LrFn, gossip_fn=None, optimizer=None,
                      metrics_fn: Callable[[FedState], dict] | None = None,
                      *, device):
    """The tree engine's round: round_fn(state, batches, draws) runs one
    step per leading index of the batch leaves ((H, n, ...)), the server
    firing on the step with (t+1) % H == 0; metrics stack to (H,).
    ``metrics_fn(state)`` is evaluated after every step and merged into
    that step's metrics.  The state passed in is donated.  A shim over
    :func:`engine.make_engine_round`."""
    espec = engine.parse_engine_spec(cfg, layout="tree")
    return engine.make_engine_round(espec, grad_fn, lr_fn, device=device,
                                    gossip_fn=gossip_fn, optimizer=optimizer,
                                    metrics_fn=metrics_fn)
