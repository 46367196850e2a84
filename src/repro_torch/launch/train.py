"""Federated LM training driver of the port (repro/launch/train.py).

Runs Algorithm 1 on the tiny dense LM, or on a ported zoo config
(``--arch``: gemma3-12b, mamba2-2.7b, deepseek-v2-lite-16b,
recurrentgemma-9b, qwen1.5-4b or nemotron-4-15b; ``--smoke`` for its
reduced variant; qwen2-vl-2b and seamless-m4t-large-v2 are refused, as
the reference's training CLI cannot train them: they train through the
engine API on launch/specs.py batches), over synthetic heterogeneous
per-agent token streams on one device (or, with ``--mesh-agents``, its
agents sharded over several).  The state is the flat (n_agents, D)
buffer (the fused round's default) or the stacked tree of the model's
dict (``--per-step``'s default, as in the reference, or
``--state-layout tree``); with
``--sweep-runs R`` it trains an R-run lattice (over seeds, H or
topologies, ``--sweep-axis``) on one (R, n_agents, D) buffer.  The gossip
mix and the fused update+mix run through the hand-written CUDA kernels
(``--gossip-impl pallas|sparse``, ``--fuse-update-mix``; their batched
forms on a lattice; kernel #1 once per leaf on the tree).
``--gossip-compress SPEC`` compresses the gossip payload with error
feedback, on the flat buffer (the EF mix kernels #9/#11 when fused, #14
on int8 × pallas), on the lattice (#10/#12 when fused) or leaf by leaf
on the tree.  ``--delta full|topk:K|lowrank:R`` exchanges each agent's
encoded delta against the initial row through the same error feedback
(flat layout, one run).  ``--optimizer sgd|momentum|adamw``.
``--ckpt-dir DIR`` saves the stacked parameters and the step at the end
(checkpoint/checkpoint.py; msgpack and zstandard); launch/serve.py
``--ckpt DIR`` serves agent 0's slice.  ``--n-total N`` trains a
population of N agents kept in a host memmap store, one sampled cohort
of ``--cohort-size`` agents a round streamed to the card
(core/population.py; the cohort mix is kernel #2), and ``--ckpt-dir``
then saves the store.  ``--mesh-agents N`` shards the flat buffer's
agent rows over N ranks, one process a rank (core/sharded.py): run it
under ``torchrun --nproc-per-node N`` (one card a rank, NCCL; gloo with
``--device cpu``); only rank 0 prints.  ``--mesh-model M`` with it
extends the mesh to 2-D (launch/mesh.make_fed_mesh(N, M), N·M ranks):
each rank holds an (n/N, D/M) block of the flat buffer, and the gossip
and server collectives stay on the agent dim (core/sharded.py).
Mistral-Large-123B and DeepSeek-V3-671B train 4 and 1 agents whatever
``--agents`` says, their replicated agent layout
(sharding.n_agents_for).  Runs on ``cuda`` unless ``--device cpu`` is
given, and fails without a card.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --gossip-impl pallas \\
      --fuse-update-mix --steps 10 [--sweep-runs 2 --sweep-axis h]
      [--gossip-compress int8 | --delta topk:4096]
      [--arch mamba2-2.7b --smoke] [--ckpt-dir DIR]
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --mesh-agents 2 --gossip-impl pallas --steps 10
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --mesh-agents 2 --mesh-model 2 --gossip-impl pallas --steps 10
  PYTHONPATH=src python -m repro_torch.launch.train --n-total 4096 \\
      --cohort-size 64 --steps 20 [--sampling stale --staleness 0.5]
      [--n-clusters 4] [--no-overlap]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import optim
from repro_torch.checkpoint import require_codecs, save_checkpoint
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ArchConfig, FedConfig
from repro_torch.core import engine as engine_lib
from repro_torch.core import feddec
from repro_torch.core import flat as flat_lib
from repro_torch.core import population as population_lib
from repro_torch.core import sharded as sharded_lib
from repro_torch.core import sweep as sweep_lib
from repro_torch.core import topology as topo
from repro_torch.core.draws import Draws, SweepDraws
from repro_torch.core.fedavg import FedAvgConfig
from repro_torch.data.federated_lm import make_federated_lm
from repro_torch.launch.mesh import make_agent_mesh, make_fed_mesh
from repro_torch.launch.steps import (build_fed_setup, flat_2d_config,
                                      sweep_lattice_configs)
from repro_torch.models import build_model
from repro_torch.sharding import MeshAxes
from repro_torch.tree import leaves

OPTIMIZERS = ("sgd", "momentum", "adamw")

__all__ = ["tiny_lm_config", "fed_axes", "build_fed_setup", "sweep_lattice_configs",
           "resolve_device", "train_loop", "population_graph",
           "population_loop", "main"]


def tiny_lm_config(d_model: int = 768, layers: int = 12,
                   vocab: int = 32_768, name: str = "tiny-lm") -> ArchConfig:
    """The ~157M-parameter dense LM of the end-to-end example."""
    return ArchConfig(
        name=name, arch_type="dense", source="examples",
        num_layers=layers, d_model=d_model,
        num_heads=d_model // 64, num_kv_heads=max(1, d_model // 128),
        d_ff=4 * d_model, vocab_size=vocab, param_dtype=torch.float32,
        compute_dtype=torch.float32)


def fed_axes(fed: FedConfig) -> MeshAxes:
    """The training CLI's mesh roles: one ``data`` axis of ``fed.n_agents``
    slices and a model axis of 1 (repro/launch/train.py:118)."""
    return MeshAxes(("data",), "model", {"data": fed.n_agents, "model": 1})


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA request without a card fails."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the port runs on "
                           "the GPU unless asked for the CPU (--device cpu "
                           "/ device='cpu')")
    return device


def _check_options(cfg: ArchConfig, fed: FedConfig, *, optimizer: str,
                   fedavg_control: bool, fused: bool, state_layout,
                   fuse_update_mix: bool, mesh_agents, mesh_model,
                   sweep_runs, ckpt_dir) -> tuple:
    """train_loop's checks of its options, in the reference's order and
    with its messages, before anything is built (the CLI runs them before
    it joins a process group); returns (state_layout, the FedDecConfig,
    n_agents)."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; choose from "
                         f"{'|'.join(OPTIMIZERS)}")
    fcfg, n_agents = build_fed_setup(cfg, fed_axes(fed), fed)
    if fedavg_control:
        fcfg = FedAvgConfig(n_agents, h=fed.h, k=fed.k)
    if state_layout is None:
        state_layout = "flat" if fused or mesh_agents else "tree"
    if state_layout not in ("tree", "flat"):
        raise ValueError(f"state_layout must be 'tree' or 'flat', "
                         f"got {state_layout!r}")
    if mesh_model is not None and mesh_model > 1:
        # the reference's model-axis lattice, its messages
        # (engine.model_axis_conflict)
        if mesh_agents is None:
            raise ValueError("--mesh-model needs --mesh-agents (the model "
                             "axis extends the agent mesh to 2-D)")
        if state_layout != "flat":
            raise engine_lib.model_axis_conflict(
                "layout 'tree' (the pytree engine has no flat buffer to "
                "column-shard)")
        if sweep_runs is not None:
            raise engine_lib.model_axis_conflict(
                "sweep lattices (--sweep-runs) until the composition lands")
        if (getattr(fcfg, "gossip_impl", "none") != "none"
                and getattr(fcfg, "delta", "none") != "none"):
            raise engine_lib.model_axis_conflict(
                "delta parameterization (--delta)")
    if mesh_agents is not None and state_layout != "flat":
        raise ValueError("--mesh-agents shards the flat (n_agents, D) "
                         "buffer; it requires --state-layout flat")
    if fuse_update_mix:
        if state_layout != "flat":
            raise ValueError("--fuse-update-mix fuses the whole-buffer "
                             "update+mix pass (kernels #3/#4); it requires "
                             "--state-layout flat")
        if mesh_agents is not None:
            raise ValueError("--fuse-update-mix is single-device: the "
                             "sharded engine overlaps its halo with "
                             "interior compute instead (core/sharded.py); "
                             "drop --mesh-agents")
    if sweep_runs is not None:
        if not fused:
            raise ValueError("--sweep-runs requires the fused executor")
        if state_layout != "flat":
            raise ValueError("--sweep-runs batches the flat (n_agents, D) "
                             "buffer; it requires --state-layout flat")
        if ckpt_dir:
            raise ValueError("checkpointing a sweep lattice is not "
                             "supported; run without --ckpt-dir")
    if ckpt_dir:
        require_codecs()
    return state_layout, fcfg, n_agents


def train_loop(cfg: ArchConfig, fed: FedConfig, *, steps: int,
               per_agent_batch: int, seq_len: int, lr: float = 3e-3,
               optimizer: str = "sgd", fedavg_control: bool = False,
               fused: bool = True, state_layout: str | None = None,
               fuse_update_mix: bool = False,
               mesh_agents: int | None = None,
               mesh_model: int | None = None,
               sweep_runs: int | None = None, sweep_axis: str = "seed",
               ckpt_dir: str | None = None, ckpt_every: int = 0,
               log_every: int = 10, seed: int = 0, data_alpha: float = 0.3,
               device="cuda", draws=None, params0: dict | None = None,
               timing: dict | None = None, keep_lattice: bool = False,
               remat: bool = True):
    """Run FedDec training; returns (final FedState, loss_history).

    ``fused=True`` runs one H-step round per call (a Python loop over the
    round's steps); ``fused=False`` calls the one-step executor per
    iteration.  Both run the same step body, so their trajectories agree.
    ``state_layout`` picks the engine: 'flat' (the (n, D) buffer) or
    'tree' (the stacked dict, core/feddec.py); by default 'flat' when
    fused and 'tree' per step, as the reference resolves it
    (repro/launch/train.py:122-123).  ``sweep_runs=R`` trains the R-run
    lattice of ``sweep_axis`` on one (R, n, D) buffer from one shared
    data stream; the loss history is the lattice mean per step, and the
    state returned is run 0's (the whole SweepFedState with
    ``keep_lattice``).  A flat state comes back as the tree FedState of
    views into its buffers (``flat.unflatten_fedstate``), as the
    reference returns it.  ``draws`` (default ``Draws(seed, device)``,
    or ``SweepDraws`` for a lattice) makes every random draw;
    ``params0`` replaces the random initial weights.  ``ckpt_dir``
    saves ``{'params': the stacked tree, 'step'}`` there every
    ``ckpt_every`` steps (when a multiple of it falls in a fused round)
    and at the end; msgpack and zstandard are checked for before the
    first step.  A ``timing`` dict
    receives ``setup_s`` and ``loop_s``, host-clock seconds (the loop
    ends by reading the losses back, which waits for the device), and
    with ``mesh_agents`` ``block_bytes``: the storage bytes of each of
    this rank's state buffers (flat, optimizer, residual) at the end.

    ``mesh_agents=N`` runs the agent-sharded engine (core/sharded.py) in
    an initialized ``torch.distributed`` group of N ranks, one process a
    rank (``torchrun --nproc-per-node N``; gloo on the CPU, NCCL with one
    card a rank): each rank trains its n_agents/N rows of the flat buffer
    (or of every run of a ``sweep_runs`` lattice), draws the same full
    batches and engine draws as the one-device run and keeps its rows,
    and the state returned is gathered whole on every rank.  Only rank 0
    prints.  ``mesh_model=M`` (with ``mesh_agents=A``) runs the 2-D engine
    on a ``make_fed_mesh(A, M)`` mesh in a group of A·M ranks: each rank
    trains its (n/A, D/M) block, gathering its rows' other columns for
    line 4 (core/sharded.py), while the gossip and server collectives
    stay on the agent dim.  Incoherent combinations (--delta, the tree
    layout, --sweep-runs) raise the reference's model-axis ValueError up
    front (repro/launch/train.py:127-143).

    ``remat`` (the reference's default, and the CLI's) rematerialises each
    scanned group in line 4's backward (``Model.grad_fn``); False keeps
    every activation, the port's addition for measuring what remat
    saves and costs.
    """
    t_setup = time.perf_counter()
    state_layout, fcfg, n_agents = _check_options(
        cfg, fed, optimizer=optimizer, fedavg_control=fedavg_control,
        fused=fused, state_layout=state_layout,
        fuse_update_mix=fuse_update_mix, mesh_agents=mesh_agents,
        mesh_model=mesh_model, sweep_runs=sweep_runs, ckpt_dir=ckpt_dir)
    device = resolve_device(device)
    cfg = flat_2d_config(cfg, mesh_model or 1)
    model = build_model(cfg)
    opt = {"sgd": None, "momentum": optim.momentum_sgd(),
           "adamw": optim.adamw()}[optimizer]
    # no exchange (FedAvg / impl 'none') ⇒ nothing to compress, no residual
    compress = fcfg.gossip_compress if fcfg.gossip_impl != "none" \
        else "none"
    delta = fcfg.delta if fcfg.gossip_impl != "none" else "none"
    eta = torch.full((1,), lr, dtype=torch.float32, device=device)
    lr_fn = lambda t: eta  # noqa: E731  (constant; stays on the device)
    if draws is None:
        draws = Draws(seed, device) if sweep_runs is None else SweepDraws(
            seed, device, sweep_runs, per_run=sweep_axis == "seed")

    mesh = rows = None
    model_ax = "model" if mesh_model is not None and mesh_model > 1 \
        else None
    if mesh_agents is not None:
        if n_agents % mesh_agents:
            raise ValueError(f"--mesh-agents {mesh_agents} must divide "
                             f"--agents {n_agents}")
        mesh = make_agent_mesh(mesh_agents, device=device.type) \
            if model_ax is None else make_fed_mesh(
                mesh_agents, mesh_model, device=device.type)
        n_local = n_agents // mesh_agents
        rank = mesh.get_local_rank("agents")
        rows = slice(rank * n_local, (rank + 1) * n_local)
    verbose = mesh is None or mesh.get_rank() == 0

    data = make_federated_lm(cfg.vocab_size, n_agents, seq_len, draws,
                             alpha=data_alpha)
    if params0 is None:
        params0 = model.init(draws)
    spec = flat_lib.make_flat_spec(params0)
    grad_fn = model.grad_fn(remat=remat)
    kwargs = dict(device=device, optimizer=opt)
    if state_layout == "tree":
        state = feddec.init_state(params0, n_agents, optimizer=opt,
                                  compress=compress)
        if fused:
            round_fn = feddec.make_feddec_round(fcfg, grad_fn, lr_fn,
                                                **kwargs)
        else:
            step = feddec.make_feddec_step(fcfg, grad_fn, lr_fn, **kwargs)
    elif sweep_runs is not None:
        plan = sweep_lib.make_sweep_plan(
            sweep_lattice_configs(fcfg, fed, sweep_runs, sweep_axis))
        state = sweep_lib.init_sweep_state(plan, spec, params0, optimizer=opt)
        if mesh is not None:
            # R runs × the agent shards: this rank's (R, n_local, D) block
            state = sharded_lib.shard_sweep_state(state, mesh)
            round_fn = sharded_lib.make_sharded_sweep_round(
                plan, spec, grad_fn, lr_fn, mesh, **kwargs)
        else:
            round_fn = sweep_lib.make_sweep_feddec_round(
                plan, spec, grad_fn, lr_fn, fuse_update_mix=fuse_update_mix,
                **kwargs)
    elif mesh is not None:
        state = sharded_lib.shard_flat_state(flat_lib.init_flat_state(
            spec, params0, n_agents, optimizer=opt, compress=compress),
            mesh, model_axis=model_ax)
        make = sharded_lib.make_sharded_feddec_round if fused \
            else sharded_lib.make_sharded_feddec_step
        engine_fn = make(fcfg, spec, grad_fn, lr_fn, mesh,
                         model_axis=model_ax, **kwargs)
        if fused:
            round_fn = engine_fn
        else:
            step = engine_fn
    else:
        state = flat_lib.init_flat_state(spec, params0, n_agents,
                                         optimizer=opt, compress=compress,
                                         delta=delta)
        kwargs["fuse_update_mix"] = fuse_update_mix
        if delta != "none":  # the shared base row: the initial weights
            kwargs["delta_base"] = spec.ravel(params0)
        if fused:
            round_fn = flat_lib.make_flat_feddec_round(fcfg, spec, grad_fn,
                                                       lr_fn, **kwargs)
        else:
            step = flat_lib.make_flat_feddec_step(fcfg, spec, grad_fn,
                                                  lr_fn, **kwargs)
    n_params = model.param_count(params0)
    del params0  # the state holds its own copies

    def save(st, done: int) -> None:
        # the stacked tree (views into a flat buffer) and t as a 0-d int32,
        # as the reference saves them; a sharded state is gathered first
        # and rank 0 writes it
        if mesh is not None:
            st = sharded_lib.gather_flat_state(st, mesh, model_axis=model_ax)
            if not verbose:
                return
        stacked = spec.unflatten(st.flat) if state_layout == "flat" \
            else st.params
        save_checkpoint(ckpt_dir, done, {
            "params": stacked,
            "step": torch.tensor(st.step, dtype=torch.int32)})

    say = print if verbose else (lambda *a, **k: None)
    say(f"[train] {cfg.name}: {n_params:,} params × {n_agents} agents, "
        f"graph={fed.graph}, H={fed.h}, K={fcfg.k}, opt={optimizer}, "
        f"executor={'fused' if fused else 'per-step'}, "
        f"layout={state_layout}"
        + (f" (sharded over {mesh_agents} devices)"
           if mesh_agents and model_ax is None else "")
        + (f" (2-D mesh: {mesh_agents} agents x {mesh_model} model)"
           if mesh_agents and model_ax is not None else "")
        + (f" (sweep lattice R={sweep_runs} axis={sweep_axis})"
           if sweep_runs else "")
        + f", gossip={fcfg.gossip_impl}"
        + (", fused-update-mix" if fuse_update_mix else "")
        + (f", compress={compress}" if compress != "none" else "")
        + (f", delta={delta}" if delta != "none" else "")
        + f", device={device}")
    positions = torch.arange(seq_len, device=device)[None, None].expand(
        n_agents if rows is None else rows.stop - rows.start,
        per_agent_batch, seq_len)
    losses: list[float] = []
    t_start = time.time()
    t_loop = time.perf_counter()

    def log_and_ckpt(prev: int, done: int) -> None:
        # fire when a multiple of the period falls in (prev, done]: a fused
        # round advances h steps at once and must not skip boundaries
        if log_every and done // log_every > prev // log_every:
            rate = done / (time.time() - t_start)
            say(f"[train] step {done:5d}  loss {losses[-1]:.4f}  "
                f"({rate:.2f} steps/s)")
        if (ckpt_dir and ckpt_every
                and done // ckpt_every > prev // ckpt_every):
            save(state, done)

    if fused:
        done = 0
        while done < steps:
            chunk = min(fed.h, steps - done)
            tokens = draws.tokens(data, per_agent_batch, chunk)
            if rows is not None:   # every rank drew all rows: its own ones
                tokens = tokens[:, rows]
            batches = {"tokens": tokens,
                       "positions": positions.expand(
                           (chunk,) + positions.shape)}
            if sweep_runs is not None:
                # one shared data stream, broadcast to every run
                batches = {k: v[:, None].expand(
                    (chunk, sweep_runs) + v.shape[1:])
                    for k, v in batches.items()}
            state, metrics = round_fn(state, batches, draws)
            loss = metrics["loss"]
            losses.extend((loss if sweep_runs is None
                           else loss.mean(dim=1)).tolist())
            done += chunk
            log_and_ckpt(done - chunk, done)
    else:
        for i in range(steps):
            tokens = draws.tokens(data, per_agent_batch, None)
            if rows is not None:
                tokens = tokens[rows]
            state, metrics = step(state, {"tokens": tokens,
                                          "positions": positions}, draws)
            losses.append(float(metrics["loss"]))
            log_and_ckpt(i, i + 1)
    if timing is not None:
        timing["setup_s"] = t_loop - t_setup
        timing["loop_s"] = time.perf_counter() - t_loop
        if mesh is not None:   # this rank's blocks, before the gather
            bufs = [state.flat, *leaves(state.opt_state),
                    *leaves(state.residual)]
            timing["block_bytes"] = [t.untyped_storage().nbytes()
                                     for t in bufs if t.ndim >= 2]
    if ckpt_dir:
        save(state, steps)
    if mesh is not None:   # the whole state, on every rank
        state = sharded_lib.gather_sweep_state(state, mesh) \
            if sweep_runs is not None else sharded_lib.gather_flat_state(
                state, mesh, model_axis=model_ax)
    if sweep_runs is not None:
        finals = metrics["loss"][-1].tolist()
        say("[train] sweep finals (last-step loss per run): "
            + ", ".join(f"r{r}={v:.4f}" for r, v in enumerate(finals)))
        if keep_lattice:
            return state, losses
        state = sweep_lib.slice_run(state, 0)
    if state_layout == "flat":
        state = flat_lib.unflatten_fedstate(spec, state)
    return state, losses


def population_graph(name: str, n_total: int) -> topo.SparseGraph:
    """A population-scale graph spec, CSR only, never dense: 'ring<k>'
    (e.g. ring2) → :func:`topology.ring_graph_csr`, the one family that
    scales to n_total = 1e6 without a dense draw."""
    if name.startswith("ring"):
        k = int(name[4:]) if name[4:] else 1
        return topo.ring_graph_csr(n_total, k)
    raise ValueError(
        f"population mode needs a CSR-scalable graph family; got "
        f"{name!r} (supported: ring<k>)")


def population_loop(cfg: ArchConfig, fed: FedConfig, *, n_total: int,
                    cohort_size: int, sampling: str = "uniform",
                    staleness: float = 0.0, n_clusters: int = 0,
                    steps: int, per_agent_batch: int, seq_len: int,
                    lr: float = 3e-3, ckpt_dir: str | None = None,
                    overlap: bool = True, seed: int = 0,
                    data_alpha: float = 0.3, device="cuda", draws=None,
                    params0: dict | None = None,
                    store_path: str | None = None,
                    timing: dict | None = None):
    """Cohort-streamed FedDec over an n_total-agent population
    (repro/launch/train.py:356-437); returns ``(store, loss_history)``,
    the store holding every agent's final row.

    The rows live in a host memmap (core/population.py: a temporary file,
    or ``store_path``); each H-step round trains one ``cohort_size``
    cohort while the next cohort's rows, subgraph tables and data batch
    are prepared (``overlap=True``).  The per-agent data table is
    (n_total, vocab).  ``fed.delta`` makes the store a DeltaStore.
    ``draws`` (default ``Draws(seed, device)``) makes every random draw,
    the cohort's tokens through ``draws.cohort_tokens``; ``params0``
    replaces the random initial weights.  ``ckpt_dir`` saves the store
    at the end (``pop_<steps>/``; no zstandard needed).  A ``timing``
    dict receives ``setup_s``, ``loop_s`` (host-clock seconds; the loop
    ends by reading the rows back), ``rounds``, ``drains`` and the
    engine's per-stage times (``PopulationEngine.stats``).
    """
    t_setup = time.perf_counter()
    if steps % fed.h:
        raise ValueError(f"population mode runs whole H-step rounds; "
                         f"--steps {steps} must be a multiple of --h "
                         f"{fed.h}")
    device = resolve_device(device)
    model = build_model(cfg)
    graph = population_graph(fed.graph, n_total)
    pspec = population_lib.PopulationSpec(
        n_total=n_total, cohort_size=cohort_size, sampling=sampling,
        staleness=staleness, max_degree=graph.max_degree,
        n_clusters=n_clusters, seed=seed)
    if fed.gossip_compress != "none":
        raise ValueError("population mode streams uncompressed rows; "
                         "--gossip-compress is not supported")
    if draws is None:
        draws = Draws(seed, device)
    # --delta here is a storage format: the host store keeps encoded delta
    # rows (core/delta.DeltaStore) and the cohort gossip runs on the
    # decoded rows; 'full' is lossless
    data = make_federated_lm(cfg.vocab_size, n_total, seq_len, draws,
                             alpha=data_alpha)
    if params0 is None:
        params0 = model.init(draws)
    spec = flat_lib.make_flat_spec(params0)
    eta = torch.full((1,), lr, dtype=torch.float32, device=device)
    lr_fn = lambda t: eta  # noqa: E731  (constant; stays on the device)
    eng = population_lib.PopulationEngine(
        pspec, spec, model.grad_fn(), lr_fn, graph, h=fed.h, k=fed.k,
        device=device, row_init=spec.ravel(params0), store_path=store_path,
        delta=fed.delta)
    print(f"[train] population: {model.param_count(params0):,} params × "
          f"n_total={n_total} (cohort {cohort_size}, sampling={sampling}"
          + (f", staleness={staleness}" if staleness else "")
          + (f", clusters={n_clusters}" if n_clusters > 1 else "")
          + f"), graph={fed.graph}, H={fed.h}, K={fed.k}, "
          + (f"delta={fed.delta}, " if fed.delta != "none" else "")
          + f"store={eng.store.nbytes / 1e6:.1f} MB host-side")
    del params0  # the store holds the rows
    positions = torch.arange(seq_len, device=device)[None, None].expand(
        cohort_size, per_agent_batch, seq_len)

    def batch_fn(round_idx: int, ids: np.ndarray):
        tokens = draws.cohort_tokens(data, ids, per_agent_batch, fed.h,
                                     round_idx)
        return {"tokens": tokens,
                "positions": positions.expand((fed.h,) + positions.shape)}

    t_start = time.time()
    t_loop = time.perf_counter()
    mets = eng.run(steps // fed.h, batch_fn, draws, overlap=overlap)
    losses = np.asarray(mets["loss"]).reshape(-1).tolist()
    rate = steps / (time.time() - t_start)
    if timing is not None:
        timing.update(setup_s=t_loop - t_setup,
                      loop_s=time.perf_counter() - t_loop,
                      rounds=steps // fed.h, drains=mets["drains"],
                      **eng.stats)
    print(f"[train] population: {steps} steps in "
          f"{steps // fed.h} rounds ({rate:.2f} steps/s, "
          f"{mets['drains']} pipeline drains)")
    if ckpt_dir:
        eng.store.save(ckpt_dir, steps)
    return eng.store, losses


# ported configs this CLI does not train: the reference's train_loop
# fails on them at its first step, because its batches carry only tokens
# and positions
_NOT_TRAINABLE = {
    "qwen2-vl-2b": "its M-RoPE attention needs mrope_positions "
                   "(repro/models/attention.py:219)",
    "seamless-m4t-large-v2": "its encoder needs enc_embeds "
                             "(repro/models/transformer.py:353)",
}
# population mode's flags that differ from their defaults compose with
# nothing here (repro/launch/train.py:568-579)
_POPULATION_EXCLUSIVE = (("--mesh-agents", "mesh_agents", None),
                         ("--mesh-model", "mesh_model", None),
                         ("--sweep-runs", "sweep_runs", None),
                         ("--fuse-update-mix", "fuse_update_mix", False),
                         ("--optimizer", "optimizer", "sgd"),
                         ("--fedavg", "fedavg", False),
                         ("--per-step", "fused", True))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    trained = [a for a in ARCH_NAMES[1:] if a not in _NOT_TRAINABLE]
    p.add_argument("--arch", default="tiny",
                   help=f"'tiny' (the ~157M dense LM) or a ported config: "
                        f"{', '.join(trained)} (not trained by this CLI: "
                        f"{', '.join(_NOT_TRAINABLE)})")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced smoke variant of --arch")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--agents", type=int, default=8)
    p.add_argument("--batch", type=int, default=2,
                   help="per-agent batch size")
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--graph", default="ring2")
    p.add_argument("--h", type=int, default=10)
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--p-fail", type=float, default=0.0)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--optimizer", default="sgd", choices=list(OPTIMIZERS))
    p.add_argument("--fedavg", action="store_true",
                   help="run the FedAvg control instead of FedDec")
    ex = p.add_mutually_exclusive_group()
    ex.add_argument("--fused", dest="fused", action="store_true",
                    default=True, help="one call per H-step round (default)")
    ex.add_argument("--per-step", dest="fused", action="store_false",
                    help="one call per iteration")
    p.add_argument("--state-layout", default=None, choices=["tree", "flat"],
                   help="carried-state engine: 'flat' = one (n, D) buffer "
                        "(default when fused), 'tree' = the stacked dict of "
                        "the model's leaves (default with --per-step)")
    p.add_argument("--gossip-impl", default="dense",
                   choices=["dense", "pallas", "sparse", "none"],
                   help="how the gossip mix executes (Algorithm 1 line 6): "
                        "'pallas' = CUDA kernel #1 (once per leaf on the "
                        "tree), 'sparse' = ELL kernel #2 on CUDA (likewise)")
    p.add_argument("--fuse-update-mix", action="store_true",
                   help="fuse the optimizer update with the gossip mix "
                        "(CUDA kernels #3/#4); sgd/momentum, flat layout")
    p.add_argument("--sweep-runs", type=int, default=None, metavar="R",
                   help="train R runs as one (R, n, D) lattice (the "
                        "batched kernels #5-#8 on CUDA)")
    p.add_argument("--sweep-axis", default="seed",
                   choices=["seed", "h", "topology"],
                   help="what the lattice's runs differ in: their draws, "
                        "H·{1,2,4,...}, or geo/er graphs drawn with seed r")
    p.add_argument("--gossip-compress", default="none", metavar="SPEC",
                   help="compress the gossip payload with error feedback "
                        "(core/compress.py): none | identity | bf16 | int8 "
                        "| topk:R; every layout, with or without "
                        "--sweep-runs")
    p.add_argument("--delta", default="none", metavar="SPEC",
                   help="delta-parameterize the agent state against a "
                        "shared base row (core/delta.py): none | full | "
                        "topk:K | lowrank:R (e.g. topk:128).  Gossip then "
                        "exchanges encoded deltas with error feedback "
                        "('full' is lossless, bit-identical to none).  "
                        "Flat layout, one run; mutually exclusive with "
                        "--gossip-compress")
    p.add_argument("--n-total", type=int, default=None, metavar="N",
                   help="population mode (core/population.py): keep N "
                        "agents in a host memmap store and train a sampled "
                        "cohort a round, its rows streamed h2d/d2h "
                        "double-buffered.  Overrides --agents; needs a "
                        "ring<k> graph and the stateless sgd optimizer")
    p.add_argument("--cohort-size", type=int, default=64, metavar="C",
                   help="agents sampled and streamed a round in population "
                        "mode")
    p.add_argument("--sampling", default="uniform",
                   choices=list(population_lib.SAMPLINGS),
                   help="population cohort sampler: uniform, weighted "
                        "(per-agent weights), or stale (agents longest out "
                        "of a cohort first)")
    p.add_argument("--staleness", type=float, default=0.0, metavar="BETA",
                   help="FedPAE-style age tilt of the cohort mixing matrix "
                        "(0 = plain doubly stochastic Metropolis)")
    p.add_argument("--n-clusters", type=int, default=0, metavar="M",
                   help="population mode: M > 1 turns on the two-tier "
                        "server round (edge-cluster averaging before the "
                        "K-sample aggregation)")
    p.add_argument("--no-overlap", dest="overlap", action="store_false",
                   default=True,
                   help="population mode: wait for the device after every "
                        "round (the synchronous schedule; same trajectory)")
    p.add_argument("--ckpt-dir", default=None,
                   help="save the stacked parameters and the step here at "
                        "the end (needs msgpack and zstandard); in "
                        "population mode, the store (needs neither)")
    p.add_argument("--mesh-agents", type=int, default=None, metavar="N",
                   help="shard the flat (n_agents, D) buffer over N ranks "
                        "(core/sharded.py), one process a rank: run under "
                        "torchrun --nproc-per-node N (one card a rank, "
                        "NCCL; gloo with --device cpu); composes with "
                        "--gossip-impl, --per-step, --gossip-compress and "
                        "--sweep-runs")
    p.add_argument("--mesh-model", type=int, default=None, metavar="M",
                   help="with --mesh-agents A, extend the mesh to 2-D "
                        "(launch/mesh.make_fed_mesh(A, M)): each agent "
                        "row's D dim is column-sharded over M ranks too, "
                        "A·M processes under torchrun --nproc-per-node "
                        "A·M; the gossip and server collectives stay on "
                        "the agent dim.  Does not compose with --delta, "
                        "--sweep-runs or --state-layout tree")
    p.add_argument("--vocab", type=int, default=32_768,
                   help="tiny-LM vocab size")
    p.add_argument("--d-model", type=int, default=768,
                   help="tiny-LM width")
    p.add_argument("--layers", type=int, default=12,
                   help="tiny-LM depth")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.arch not in ARCH_NAMES:
        p.error(f"unknown --arch {args.arch!r}; choose from "
                f"{', '.join(ARCH_NAMES)}")
    if args.arch in _NOT_TRAINABLE:
        p.error(f"--arch {args.arch} is not trained by this CLI: the "
                f"reference's train_loop fails on it at its first step, "
                f"because its batches carry only tokens and positions and "
                f"{_NOT_TRAINABLE[args.arch]}; train it through the engine "
                f"API (core/feddec.py) on launch/specs.py concrete_batch "
                f"batches")

    if args.arch == "tiny":
        cfg = tiny_lm_config(args.d_model, args.layers, vocab=args.vocab)
    else:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = cfg.smoke()
    fed = FedConfig(n_agents=args.agents, h=args.h, k=args.k,
                    graph=args.graph, p_fail=args.p_fail,
                    gossip_impl=args.gossip_impl,
                    gossip_compress=args.gossip_compress, delta=args.delta)
    if args.n_total is not None:
        for flag, dest, default in _POPULATION_EXCLUSIVE:
            if getattr(args, dest) != default:
                raise SystemExit(f"population mode (--n-total) does not "
                                 f"compose with {flag}")
        _, losses = population_loop(
            cfg, fed, n_total=args.n_total, cohort_size=args.cohort_size,
            sampling=args.sampling, staleness=args.staleness,
            n_clusters=args.n_clusters, steps=args.steps,
            per_agent_batch=args.batch, seq_len=args.seq, lr=args.lr,
            ckpt_dir=args.ckpt_dir, overlap=args.overlap,
            device=args.device)
        _print_done(losses)
        return
    if args.mesh_agents is None:
        _print_done(_train(args, cfg, fed)[1])
        return
    import torch.distributed as dist
    # before the group is joined; train_loop runs these cheap checks again
    _check_options(cfg, fed, **_options(args))
    rank = _init_ranks(p, args.mesh_agents, args.mesh_model or 1,
                       args.device)
    try:
        losses = _train(args, cfg, fed)[1]
    finally:
        dist.destroy_process_group()
    if rank == 0:
        _print_done(losses)


def _options(args) -> dict:
    """The CLI's arguments that _check_options checks."""
    return dict(optimizer=args.optimizer, fedavg_control=args.fedavg,
                fused=args.fused, state_layout=args.state_layout,
                fuse_update_mix=args.fuse_update_mix,
                mesh_agents=args.mesh_agents, mesh_model=args.mesh_model,
                sweep_runs=args.sweep_runs, ckpt_dir=args.ckpt_dir)


def _train(args, cfg: ArchConfig, fed: FedConfig):
    """train_loop with the CLI's arguments."""
    return train_loop(
        cfg, fed, steps=args.steps, per_agent_batch=args.batch,
        seq_len=args.seq, lr=args.lr, sweep_axis=args.sweep_axis,
        device=args.device, **_options(args))


def _init_ranks(p: argparse.ArgumentParser, n: int, m: int,
                device: str) -> int:
    """The process group of ``--mesh-agents n [--mesh-model m]``:
    torchrun's (its WORLD_SIZE, RANK and LOCAL_RANK in the environment),
    or, without torchrun, a world of one.  The world must hold n·m ranks.
    On cuda each rank takes card LOCAL_RANK and NCCL; on the CPU gloo.
    Returns this process's rank."""
    import os

    import torch.distributed as dist
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != n * m:
        flags = f"--mesh-agents {n}" + (f" --mesh-model {m}" if m > 1
                                        else "")
        p.error(f"{flags} needs {n * m} ranks, one process a rank, "
                f"but this world has {world} (start it with torchrun "
                f"--nproc-per-node {n * m})")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        resolve_device(device)
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        backend = "nccl" if cuda else "gloo"
        if "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    return dist.get_rank()


def _print_done(losses: list) -> None:
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    print(f"[train] done: loss {first:.4f} → {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()
