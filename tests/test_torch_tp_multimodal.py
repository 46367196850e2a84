"""Tensor-parallel Qwen2-VL and SeamlessM4T (models/attention.py's M-RoPE
self-attention and cross-attention on the rank's heads, models/
transformer.py's encoder stack on the rank's blocks and the vision
prefix, sharding/tp.py's ``check_family``), against the JAX package,
whose model compute GSPMD partitions from the same ``param_pspecs``
placements.

One spawned gloo world of 4 ranks (started once for the module by a
fixture, while this process computes the reference's results and the
port's one-device twins) builds the meshes (1, 2) (two replicas, each a
(1, 2) slice of a 3-D mesh), (2, 2) and (1, 4) in turn and runs:

* at M = 2 and M = 4 (A = 1), against the reference's single-device
  functions at the smoke widths (d 256, heads of 64), on x (2, 32, 256)
  and an encoder memory (2, 12, 256), each output y and the gradients of
  Σ y·r with respect to x (and the memory): the M-RoPE self-attention
  (Qwen2-VL's, with biases, three distinct (t, h, w) position
  components) in layouts (a) (4 heads over 2 KV heads at M = 2; 6 over
  2 at M = 2), (b) (4 over 2 at M = 4) and (c) (6 over 2 at M = 4, with
  ``attn_weight_gather``), under impl 'xla' and 'pallas'; the
  cross-attention in layouts (a) (SeamlessM4T's 4 heads) and (b) (4 over
  2 KV heads at M = 4); SeamlessM4T's encoder block (unmasked) and its
  decoder block with the cross-attention; four models (Qwen2-VL's smoke
  config with its 8 stub patch positions, the same at 6 heads over 2 KV
  heads, SeamlessM4T's smoke config, and SeamlessM4T's at a vocabulary
  of 511, which the group does not divide: its table and head cut on d):
  logits under impl 'xla' and 'pallas', loss and every gradient (each
  rank's blocks put together), with remat on and off (equal bit for
  bit); the kernel wrappers refuse a strided input there, as they do on
  the card;
* the tree round (n 4, ring k 1, Metropolis with link failures p 0.1,
  H 2, K 2, 2 steps, batch 1 × 16 tokens with the models' multimodal
  inputs) of Qwen2-VL's and SeamlessM4T's smoke models at (1, 2), (2, 2)
  and (1, 4) under 'dense', 'pallas' and 'sparse' in turn, against the
  port's own one-device tree round (which tests/test_torch_multimodal.py
  and test_torch_train_zoo.py hold to the reference) on the same draws,
  and each rank's state: exactly Σ over leaves of (n/A)·numel/M_leaf
  f32 elements.

In this process: ``check_family`` passing both models and refusing the
replicated layout, a cross-attention whose heads the model group does
not divide refused, and the dry run's tree train records of both on the
partitioned 16 × 16 world.

Tolerances: layers within 1e-5·max|y|, logits 1e-4·max|logit|, losses
1e-5 relative, gradients 1e-5·max|g|, the rounds' end states
1e-5·max|x| (TOL).  The spawned ranks import this module: its module
level imports no jax.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import types

import numpy as np
import pytest
import torch

from repro_torch import sharding as shd
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core import feddec, sharded
from repro_torch.core.draws import Draws
from repro_torch.launch import steps
from repro_torch.models import attention, build_model, transformer
from repro_torch.sharding import tp
from repro_torch.tree import leaves, tree_map
import _torch_tp_common as tpc
from _torch_tp_common import (
    B, IMPLS, LOGIT_TOL, LR, MESHES, N, S, T, TOL, WORLD, TableDraws)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

X_SHAPE, MEM_LEN = (2, 32, 256), 12
QWEN, SEAMLESS = "qwen2-vl-2b", "seamless-m4t-large-v2"
# model case -> (arch, (heads, KV heads) or None for the smoke ones,
# vocabulary or None for the smoke one)
MODELS = {"qwen": (QWEN, None, None), "qwen-h6": (QWEN, (6, 2), None),
          "seamless": (SEAMLESS, None, None),
          "seamless-v511": (SEAMLESS, None, 511)}
ROUND_MODELS = ("qwen", "seamless")
# attention layer cases: (name, M) -> layout; name -> (heads, KV heads)
ATTN_HEADS = {"h4kv2": (4, 2), "h6kv2": (6, 2)}
ATTN_CASES = {("h4kv2", 2): "a", ("h6kv2", 2): "a", ("h4kv2", 4): "b",
              ("h6kv2", 4): "c"}
# cross-attention cases: (name, M) -> layout; name -> (heads, KV heads)
CROSS_HEADS = {"h4kv4": (4, 4), "h4kv2": (4, 2)}
CROSS_CASES = {("h4kv4", 2): "a", ("h4kv4", 4): "a", ("h4kv2", 4): "b"}
HEAD_DIM = 64


def _cfg(case: str, side: str = "port"):
    if side == "port":
        zoo = get_config
    else:
        from repro.configs import get_config as zoo
    arch, heads, vocab = MODELS[case]
    cfg = zoo(arch).smoke()
    if heads:
        cfg = dataclasses.replace(cfg, num_heads=heads[0],
                                  num_kv_heads=heads[1])
    if vocab:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    return cfg


def _attn_cfg(heads: tuple, m: int, cross: bool = False):
    """A Qwen2-VL (self-attention, biases) or SeamlessM4T
    (cross-attention) smoke config at ``heads``, adapted to M."""
    cfg = dataclasses.replace(get_config(SEAMLESS if cross else QWEN)
                              .smoke(), num_heads=heads[0],
                              num_kv_heads=heads[1])
    return steps.adapt_for_mesh(cfg, tpc.axes(1, m))


# ---------------------------------------------------------------------------
# The port's side: runs in every rank (no jax in what it calls)
# ---------------------------------------------------------------------------


class _DenseKernelInputs:
    """The kernel wrapper #15 made to refuse a strided tensor, as it does
    on the card (on the CPU it takes its plain version, which takes any
    strides)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.saved = ops.flash_attention

        def call(*args, **kw):
            for t in args:
                if isinstance(t, torch.Tensor):
                    assert t.is_contiguous(), t.stride()
            return self.saved(*args, **kw)

        ops.flash_attention = call

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_attention = self.saved


def _with_grads(fn, inputs: dict, r) -> dict:
    """y = fn(**inputs) and the gradients of Σ y·r with respect to each
    input (replicated: whole on every rank)."""
    ins = {k: v.clone().requires_grad_() for k, v in inputs.items()}
    y = fn(**ins)
    grads = torch.autograd.grad((y * r).sum(), list(ins.values()))
    return {"y": y, **{f"g{k}": g for k, g in zip(ins, grads)}}


def _run_layers(inp: dict, mesh) -> dict:
    """The attention layers, the blocks and the models on this rank's
    blocks, made whole."""
    g = tp.ModelGroup.of(mesh)
    m = g.size
    out = {}
    x, r = torch.from_numpy(inp["x"]), torch.from_numpy(inp["r"])
    pos, mem = torch.from_numpy(inp["pos"]), torch.from_numpy(inp["mem"])
    mpos = torch.from_numpy(inp["mpos"])
    for (name, mm), _ in ATTN_CASES.items():
        if mm != m:
            continue
        cfg = _attn_cfg(ATTN_HEADS[name], m)
        p = tpc.blocks({"attn": tpc.to_torch(inp["attn"][name])}, cfg,
                       mesh)["attn"]
        for impl in ("xla", "pallas"):
            def self_attn(x):
                return attention.attention(
                    p, x, pos, head_dim=HEAD_DIM, rope_kind="mrope",
                    rope_theta=cfg.rope_theta, mrope_positions=mpos, tp=g,
                    num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                    weight_gather=cfg.attn_weight_gather, impl=impl)[0]
            if impl == "xla":
                out[f"attn-{name}-{impl}"] = _with_grads(self_attn,
                                                         {"x": x}, r)
            else:   # #15 has no backward: the forward alone
                with torch.no_grad(), _DenseKernelInputs():
                    out[f"attn-{name}-{impl}"] = {"y": self_attn(x)}
    for (name, mm), _ in CROSS_CASES.items():
        if mm != m:
            continue
        cfg = _attn_cfg(CROSS_HEADS[name], m, cross=True)
        p = tpc.blocks({"cross_attn": tpc.to_torch(inp["cross"][name])}, cfg,
                    mesh)["cross_attn"]

        def cross_attn(x, mem):
            return attention.attention(
                p, x, pos, head_dim=HEAD_DIM, rope_kind="none",
                kv_override=mem, causal=False, tp=g,
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads)[0]
        out[f"cross-{name}"] = _with_grads(cross_attn, {"x": x, "mem": mem},
                                           r)
    scfg = steps.adapt_for_mesh(_cfg("seamless"), tpc.axes(1, m))
    enc_blk, dec_blk = (tpc.blocks({"b": tpc.to_torch(inp[k])}, scfg,
                                   mesh)["b"]
                        for k in ("enc_block", "dec_block"))
    out["enc-block"] = _with_grads(
        lambda x: transformer.apply_block(enc_blk, x, pos, scfg, 0,
                                          causal=False, tp=g)[0],
        {"x": x}, r)
    out["dec-block"] = _with_grads(
        lambda x, mem: transformer.apply_block(dec_blk, x, pos, scfg, 0,
                                               enc_out=mem, tp=g)[0],
        {"x": x, "mem": mem}, r)
    for case in MODELS:
        cfg = steps.adapt_for_mesh(_cfg(case), tpc.axes(1, m))
        model = build_model(cfg)
        whole = tpc.to_torch(inp["params"][case])
        params = tpc.blocks(whole, cfg, mesh)
        batch = tpc.to_torch(inp["batch"][case])
        with tp.model_group(mesh):
            for impl in ("xla", "pallas"):
                with _DenseKernelInputs():
                    lg = model.logits(params, batch, impl=impl)
                if lg.shape[-1] != cfg.vocab_size:
                    lg = tp._gather(lg, g, 2)
                out[f"{case}-logits-{impl}"] = lg
            for remat in (True, False):
                loss, grads = model.grad_fn(remat=remat)(params, batch)
                out[f"{case}-loss-{remat}"] = loss
                out[f"{case}-grads-{remat}"] = tpc.whole(grads, whole, cfg,
                                                      mesh)
    return tpc.to_numpy(out)


def _run_tp_round(mesh, case, impl, start, batches, draws):
    """This rank's tensor-parallel tree round: the gathered end state,
    the losses and this rank's bytes."""
    a = mesh.get_local_rank("agents")
    n_local = N // int(mesh.mesh.shape[0])
    tcfg = steps.adapt_for_mesh(_cfg(case), tp.mesh_axes(mesh))
    state = tpc.start_state(start)
    specs = shd.param_pspecs(tcfg, state.params, tp.mesh_axes(mesh))
    blk = sharded.shard_tree_state(state, specs, mesh)
    rnd = sharded.make_sharded_tree_round(
        tpc.round_setup(impl), build_model(tcfg).grad_fn(), lambda t: LR, mesh,
        device="cpu", param_specs=specs)
    rows = slice(a * n_local, (a + 1) * n_local)
    blk, met = rnd(blk, {k: torch.from_numpy(v[:, rows])
                         for k, v in batches.items()}, draws)
    ts = [t for t in leaves(blk.params) if t.ndim > 1]
    nbytes = (sum(t.numel() * t.element_size() for t in ts),
              sum(t.untyped_storage().nbytes() for t in ts))
    whole = sharded.gather_tree_state(blk, specs, mesh)
    return {"params": tpc.to_numpy(whole.params),
            "losses": met["loss"].tolist(),
            "bytes": nbytes}


def _run_twin(case, impl, start, batches, draws):
    """The port's one-device tree round."""
    rnd = feddec.make_feddec_round(tpc.round_setup(impl),
                                   build_model(_cfg(case)).grad_fn(),
                                   lambda t: LR, device="cpu")
    state, met = rnd(tpc.start_state(start), tpc.to_torch(batches), draws)
    return {"params": tpc.to_numpy(state.params),
            "losses": met["loss"].tolist()}


def _world_main(rank, world, store_path, inputs_path, out_path):
    """One rank of the spawned gloo world; rank 0 writes what every rank
    reported."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        inp = tpc.wait_for(inputs_path)
        mine = {}
        for i, (a, m) in enumerate(MESHES):
            mesh = tpc.fed_mesh(a, m)
            if a == 1 and rank < a * m:
                mine[("layers", m)] = _run_layers(inp, mesh)
            for case in ROUND_MODELS:
                mine[("round", case, a, m)] = _run_tp_round(
                    mesh, case, IMPLS[i], inp["start"][case],
                    inp["batches"][case], TableDraws(inp["tables"]))
        every = [None] * world
        dist.all_gather_object(every, mine)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(every, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The reference's side and the inputs (this process)
# ---------------------------------------------------------------------------


def _mrope_positions(rng, lead: tuple, s: int) -> np.ndarray:
    """(..., 3, B, S) ids (``lead`` = (..., B)): the temporal component
    the sequence position, height and width drawn, so the three
    differ."""
    t = np.broadcast_to(np.arange(s), lead + (s,))
    hw = rng.integers(0, s, size=(2,) + lead + (s,))
    ids = np.concatenate([t[None], hw])
    return np.moveaxis(ids, 0, len(lead) - 1)


def _batch(cfg, rng, lead: tuple, s: int, mem_len: int) -> dict:
    """A numpy batch of ``cfg`` with every input its model takes, leaves
    (*lead, ...), ``lead`` ending in the batch dim."""
    out = {"tokens": rng.integers(0, cfg.vocab_size, lead + (s,)),
           "positions": np.broadcast_to(np.arange(s), lead + (s,)).copy()}
    if cfg.rope_kind == "mrope":
        out["mrope_positions"] = _mrope_positions(rng, lead, s)
    if cfg.frontend == "vision":
        out["frontend_embeds"] = (0.02 * rng.standard_normal(
            lead + (cfg.frontend_positions, cfg.d_model))).astype(
            np.float32)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = (0.5 * rng.standard_normal(
            lead + (mem_len, cfg.d_model))).astype(np.float32)
    return out


def _attn_params(rng, heads: tuple, bias: bool) -> dict:
    d = X_SHAPE[-1]
    h, kv = heads

    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    p = {"wq": {"w": w(d, h, HEAD_DIM, fan_in=d)},
         "wk": {"w": w(d, kv, HEAD_DIM, fan_in=d)},
         "wv": {"w": w(d, kv, HEAD_DIM, fan_in=d)},
         "wo": {"w": w(h, HEAD_DIM, d, fan_in=h * HEAD_DIM)}}
    if bias:
        for name, n in (("wq", h), ("wk", kv), ("wv", kv)):
            p[name]["b"] = (0.1 * rng.standard_normal((n, HEAD_DIM))
                            ).astype(np.float32)
    return p


def _inputs() -> dict:
    rng = np.random.default_rng(0)

    def perturb(p):
        return (p.numpy() + 0.01 * rng.standard_normal(p.shape)).astype(
            np.float32)

    b, s, _ = X_SHAPE
    inp = {"params": {}, "batch": {}, "start": {}, "batches": {},
           "tables": tpc.tables(),
           "x": rng.standard_normal(X_SHAPE).astype(np.float32),
           "r": rng.standard_normal(X_SHAPE).astype(np.float32),
           "mem": rng.standard_normal((b, MEM_LEN, X_SHAPE[-1])).astype(
               np.float32),
           "pos": np.broadcast_to(np.arange(s), (b, s)).copy(),
           "mpos": _mrope_positions(rng, (b,), s),
           "attn": {n: _attn_params(rng, h, True)
                    for n, h in ATTN_HEADS.items()},
           "cross": {n: _attn_params(rng, h, n == "h4kv2")
                     for n, h in CROSS_HEADS.items()}}
    for case in MODELS:
        cfg = _cfg(case)
        params = build_model(cfg).init(Draws(5, "cpu"))
        inp["params"][case] = tree_map(perturb, params)
        inp["batch"][case] = _batch(cfg, rng, (2,), 2 * S, MEM_LEN)
    sm = inp["params"]["seamless"]
    inp["enc_block"] = tree_map(lambda p: p[0],
                                sm["enc_stack"]["scan"]["sub_0"])
    inp["dec_block"] = tree_map(lambda p: p[0], sm["stack"]["scan"]["sub_0"])
    for case in ROUND_MODELS:
        cfg = _cfg(case)
        start = build_model(cfg).init(Draws(3, "cpu"))
        inp["start"][case] = tree_map(lambda p: (
            p.numpy()[None] + 0.01 * rng.normal(size=(N,) + tuple(p.shape))
        ).astype(np.float32), start)
        inp["batches"][case] = _batch(cfg, rng, (T, N, B), S, S // 2)
    return inp


def _jax_batch(batch: dict) -> dict:
    import jax.numpy as jnp
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
            for k, v in batch.items()}


def _reference(inp: dict) -> dict:
    """The reference's single-device layers and models."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as ref_attn
    from repro.models import build_model as ref_build_model
    from repro.models import transformer as ref_tf
    j = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    x, r, mem = (jnp.asarray(inp[k]) for k in ("x", "r", "mem"))
    pos, mpos = (jnp.asarray(inp[k], jnp.int32) for k in ("pos", "mpos"))

    def with_grads(fn, *args):
        y, vjp = jax.vjp(fn, *args)
        return (y, *vjp(r))

    out = {}
    qcfg = _cfg("qwen", "ref")
    for name in ATTN_HEADS:
        p = j(inp["attn"][name])
        y, gx = with_grads(lambda x: ref_attn.attention(
            p, x, pos, num_kv_heads=ATTN_HEADS[name][1], head_dim=HEAD_DIM,
            rope_kind="mrope", rope_theta=qcfg.rope_theta,
            mrope_positions=mpos, compute_dtype=jnp.float32)[0], x)
        out[f"attn-{name}"] = {"y": y, "gx": gx}
    for name in CROSS_HEADS:
        p = j(inp["cross"][name])
        y, gx, gm = with_grads(lambda x, m: ref_attn.attention(
            p, x, pos, num_kv_heads=CROSS_HEADS[name][1], head_dim=HEAD_DIM,
            rope_kind="none", kv_override=m, causal=False,
            compute_dtype=jnp.float32)[0], x, mem)
        out[f"cross-{name}"] = {"y": y, "gx": gx, "gmem": gm}
    scfg = _cfg("seamless", "ref")
    enc, dec = j(inp["enc_block"]), j(inp["dec_block"])
    y, gx = with_grads(lambda x: ref_tf.apply_block(
        enc, x, pos, scfg, 0, causal=False)[0], x)
    out["enc-block"] = {"y": y, "gx": gx}
    y, gx, gm = with_grads(lambda x, m: ref_tf.apply_block(
        dec, x, pos, scfg, 0, enc_out=m)[0], x, mem)
    out["dec-block"] = {"y": y, "gx": gx, "gmem": gm}
    for case in MODELS:
        model = ref_build_model(_cfg(case, "ref"))
        params, batch = j(inp["params"][case]), _jax_batch(
            inp["batch"][case])
        out[f"{case}-logits"] = model.logits(params, batch)[0]
        out[f"{case}-loss"], out[f"{case}-grads"] = jax.jit(
            model.grad_fn())(params, batch, jax.random.key(0))
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's report and this process's reference results and
    one-device twins: the world runs while this process computes them."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("tp_multimodal")
    inputs, out_path = tmp / "inputs.pkl", tmp / "out.pkl"
    ctx = mp.start_processes(
        _world_main, args=(WORLD, str(tmp / "store"), str(inputs),
                           str(out_path)),
        nprocs=WORLD, start_method="spawn", join=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inp = _inputs()
        with open(tmp / "inputs.tmp", "wb") as f:
            pickle.dump(inp, f)
        os.replace(tmp / "inputs.tmp", inputs)
        twins = {(case, impl): _run_twin(case, impl, inp["start"][case],
                                         inp["batches"][case],
                                         TableDraws(inp["tables"]))
                 for case in ROUND_MODELS for impl in IMPLS}
    finally:
        torch.set_num_threads(threads)
    want = _reference(inp)
    while not ctx.join():
        pass
    with open(out_path, "rb") as f:
        every = pickle.load(f)
    return {"ranks": every, "want": want, "twins": twins}


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def _assert_layer(got: dict, want: dict):
    """y and each gradient the port computed within TOL·max of the
    reference's."""
    assert "y" in got and set(got) <= set(want)
    for key in got:
        tpc.assert_close(got[key], want[key], TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name,m", list(ATTN_CASES),
                         ids=[f"{n}-m{m}-{b}" for (n, m), b in
                              ATTN_CASES.items()])
def test_tp_mrope_attention_matches_reference(world, name, m, impl):
    """The M-RoPE self-attention on the rank's heads in the reference's
    layouts (a), (b), (c): y (and under 'xla' x's gradient; #15 has no
    backward) within 1e-5·max of its single-device function's, the same
    on every rank of the group."""
    cfg = _attn_cfg(ATTN_HEADS[name], m)
    assert ATTN_CASES[(name, m)] == (
        "c" if cfg.attn_weight_gather else
        "a" if cfg.num_kv_heads % m == 0 else "b")
    got = world["ranks"][0][("layers", m)][f"attn-{name}-{impl}"]
    assert set(got) == ({"y", "gx"} if impl == "xla" else {"y"})
    _assert_layer(got, world["want"][f"attn-{name}"])
    for rank in world["ranks"][1:m]:
        np.testing.assert_array_equal(
            tpc.flat(rank[("layers", m)][f"attn-{name}-{impl}"]),
            tpc.flat(got))


@pytest.mark.parametrize("name,m", list(CROSS_CASES),
                         ids=[f"{n}-m{m}-{b}" for (n, m), b in
                              CROSS_CASES.items()])
def test_tp_cross_attention_matches_reference(world, name, m):
    """The cross-attention on the rank's heads: y, x's gradient and the
    encoder memory's (summed over the group by its own copy_to) within
    1e-5·max of the reference's."""
    got = world["ranks"][0][("layers", m)][f"cross-{name}"]
    _assert_layer(got, world["want"][f"cross-{name}"])
    for rank in world["ranks"][1:m]:
        np.testing.assert_array_equal(
            tpc.flat(rank[("layers", m)][f"cross-{name}"]), tpc.flat(got))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("block", ["enc-block", "dec-block"])
def test_tp_encoder_and_decoder_blocks_match_reference(world, block, m):
    """SeamlessM4T's encoder block (unmasked) and its decoder block with
    the cross-attention, on the rank's blocks: y and the gradients (x's
    and the memory's) within 1e-5·max of the reference's."""
    _assert_layer(world["ranks"][0][("layers", m)][block],
                  world["want"][block])


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", list(MODELS))
def test_tp_multimodal_models_match_reference(world, case, m):
    """Each model on the blocks: logits under both impls (put together
    over the vocabulary where it is cut) 1e-4·max|logit|, the loss 1e-5,
    every gradient 1e-5·max|g|, the same loss on every rank of the
    group."""
    out = world["ranks"][0][("layers", m)]
    want = world["want"]
    for impl in ("xla", "pallas"):
        tpc.assert_close(out[f"{case}-logits-{impl}"], want[f"{case}-logits"],
                      LOGIT_TOL)
    np.testing.assert_allclose(out[f"{case}-loss-True"], want[f"{case}-loss"],
                               rtol=TOL)
    tpc.assert_close(out[f"{case}-grads-True"], want[f"{case}-grads"], TOL)
    for rank in world["ranks"][1:m]:
        assert rank[("layers", m)][f"{case}-loss-True"] == \
            out[f"{case}-loss-True"]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", list(MODELS))
def test_tp_multimodal_remat_on_and_off_are_equal_bit_for_bit(world, case,
                                                              m):
    out = world["ranks"][0][("layers", m)]
    assert out[f"{case}-loss-True"] == out[f"{case}-loss-False"]
    np.testing.assert_array_equal(tpc.flat(out[f"{case}-grads-True"]),
                                  tpc.flat(out[f"{case}-grads-False"]))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("part", ["embed", "head"])
def test_seamless_d_sharded_table_and_head_match_reference(world, part, m):
    """SeamlessM4T at a vocabulary of 511, which neither group divides
    (as 4 and 16 do not divide its 256,206): the table and the head are
    cut on d, the logits are whole on every rank, and the table's and
    head's gradients are the reference's within 1e-5·max|g|."""
    cfg = _cfg("seamless-v511")
    shapes = build_model(cfg).init_shapes()
    specs = shd.param_pspecs(cfg, tree_map(lambda t: t[None], shapes),
                             tpc.axes(1, m))
    if part == "embed":
        assert specs["embed"]["table"] == ("agents", None, "model")
    else:
        assert specs["head"]["w"] == ("agents", "model", None)
    out = world["ranks"][0][("layers", m)]
    want = world["want"]["seamless-v511-grads"][part]
    tpc.assert_close(out["seamless-v511-grads-True"][part], want, TOL)
    tpc.assert_close(out["seamless-v511-logits-xla"],
                  world["want"]["seamless-v511-logits"], LOGIT_TOL)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("part", ["enc_stack", "enc_norm", "cross_attn"])
def test_tp_encoder_and_cross_attention_gradients_match_reference(
        world, part, m):
    """The encoder's and the cross-attentions' weights get the
    reference's gradients: the memory's gradient, partial on each rank,
    is summed before it enters the encoder."""
    got = world["ranks"][0][("layers", m)]["seamless-grads-True"]
    want = world["want"]["seamless-grads"]
    if part == "cross_attn":
        got = got["stack"]["scan"]["sub_0"][part]
        want = want["stack"]["scan"]["sub_0"][part]
    else:
        got, want = got[part], want[part]
    tpc.assert_close(got, want, TOL)


ROUND_IDS = [(c, a, m) for c in ROUND_MODELS for a, m in MESHES]


@pytest.mark.parametrize("case,a,m", ROUND_IDS,
                         ids=[f"{c}-{a}x{m}" for c, a, m in ROUND_IDS])
def test_tp_multimodal_tree_round_matches_one_device_twin(world, case, a,
                                                          m):
    """The round's end state within TOL·max|x| of the one-device twin's
    and its losses 1e-5: the batch's patch embeddings, M-RoPE ids and
    encoder frames reach every model rank of an agent unchanged (every
    rank reports the same losses)."""
    impl = IMPLS[MESHES.index((a, m))]
    want = world["twins"][(case, impl)]
    got = world["ranks"][0][("round", case, a, m)]
    tpc.assert_close(got["params"], want["params"], TOL)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
    for rep in world["ranks"][1:]:
        assert rep[("round", case, a, m)]["losses"] == got["losses"]


@pytest.mark.parametrize("case,a,m", ROUND_IDS,
                         ids=[f"{c}-{a}x{m}" for c, a, m in ROUND_IDS])
def test_each_rank_holds_exactly_its_multimodal_blocks(world, case, a, m):
    cfg = _cfg(case)
    shapes = feddec.init_state(build_model(cfg).init_shapes(), N).params
    mesh = types.SimpleNamespace(mesh_dim_names=("agents", "model"),
                                 mesh=np.zeros((a, m)))
    axes = tp.mesh_axes(mesh)
    specs = shd.param_pspecs(cfg, shapes, axes)
    want = 4 * sum(tp.block_numel(tuple(s.shape), sp, axes.sizes)
                   for s, sp in zip(leaves(shapes), leaves(specs))
                   if len(s.shape) > 1)
    if case == "seamless":
        cross = specs["stack"]["scan"]["sub_0"]["cross_attn"]
        assert cross["wk"]["w"] == ("agents", None, None, "model", None)
        assert cross["wo"]["w"] == ("agents", None, "model", None, None)
        enc = specs["enc_stack"]["scan"]["sub_0"]["attn"]
        assert enc["wq"]["w"] == ("agents", None, None, "model", None)
    else:
        attn = specs["stack"]["scan"]["sub_0"]["attn"]
        assert attn["wk"]["w"] == ((
            "agents", None, None, "model", None) if m == 2
            else ("agents", None, None, None, None))
    for rep in world["ranks"]:
        elems, storage = rep[("round", case, a, m)]["bytes"]
        assert elems == storage == want


# ---------------------------------------------------------------------------
# in this process: the family check, the refusal, the dry run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [QWEN, SEAMLESS])
def test_check_family_passes_qwen2_vl_and_seamless(arch):
    tp.check_family(get_config(arch))
    tp.check_family(get_config(arch).smoke())


@pytest.mark.parametrize("arch", ["mistral-large-123b", "deepseek-v3-671b"])
def test_check_family_refuses_the_replicated_layout(arch):
    """The replicated layout's FSDP over the data axes is the one family
    left (Queue A item 6.4), at full and at smoke widths."""
    for cfg in (get_config(arch), get_config(arch).smoke()):
        with pytest.raises(NotImplementedError,
                           match=r"Queue A item 6\.4\b"):
            tp.check_family(cfg)


def _fake_rank0(cfg, m: int):
    """Rank 0's blocks (meta) of ``cfg``'s params on a (1, M) mesh."""
    shapes = build_model(cfg).init_shapes()
    specs = shd.param_pspecs(cfg, tree_map(lambda t: t[None], shapes),
                             tpc.axes(1, m))
    return tree_map(lambda t: t[0], tp.shard_params(
        tree_map(lambda t: t[None], shapes), specs, None,
        coords={"agents": (0, 1), "model": (0, m)}))


def _meta_batch(cfg, s: int, mem_len: int) -> dict:
    batch = {k: torch.zeros((1, s), dtype=torch.long, device="meta")
             for k in ("tokens", "positions")}
    if cfg.rope_kind == "mrope":
        batch["mrope_positions"] = torch.zeros((3, 1, s), dtype=torch.long,
                                               device="meta")
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = torch.zeros(
            (1, cfg.frontend_positions, cfg.d_model), device="meta")
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = torch.zeros((1, mem_len, cfg.d_model),
                                          device="meta")
    return batch


def _with_fake_group(m: int, fn):
    with steps._fake_world(m):
        tp._ACTIVE["model"] = tp.ModelGroup(None, 0, m)
        try:
            return fn()
        finally:
            tp._ACTIVE.pop("model", None)


def test_cross_attention_whose_heads_the_group_does_not_divide_is_refused():
    """SeamlessM4T at 6 heads (and 6 KV heads) over a model group of 4:
    its self-attentions take layout (c) (the sequence split), and its
    cross-attention, not ported for such heads, raises and says so."""
    cfg = dataclasses.replace(get_config(SEAMLESS).smoke(), num_heads=6,
                              num_kv_heads=6)
    cfg = steps.adapt_for_mesh(cfg, tpc.axes(1, 4))
    assert cfg.attn_weight_gather
    model = build_model(cfg)
    params = _fake_rank0(cfg, 4)
    batch = _meta_batch(cfg, 8, 8)
    with pytest.raises(NotImplementedError,
                       match=r"cross-attention whose heads the model group "
                             r"does not divide \(6 over 4\)"):
        _with_fake_group(4, lambda: model.logits(params, batch))


@pytest.mark.parametrize("arch", [QWEN, SEAMLESS])
def test_tp_multimodal_logits_trace_on_a_fake_group(arch):
    """Each model's logits on rank 0's blocks of a model group of 2 (a
    fake world: shapes only) are its block of the vocabulary."""
    cfg = steps.adapt_for_mesh(get_config(arch).smoke(), tpc.axes(1, 2))
    logits = _with_fake_group(2, lambda: build_model(cfg).logits(
        _fake_rank0(cfg, 2), _meta_batch(cfg, 16, 8)))
    assert tuple(logits.shape) == (1, 16, cfg.vocab_size // 2)


@pytest.mark.parametrize("arch", [QWEN, SEAMLESS])
def test_dryrun_tree_record_is_the_partitioned_program(arch, tmp_path,
                                                       monkeypatch):
    """The tree train record on the 16 × 16 world at the smoke widths
    (Qwen2-VL's 4 heads, which 16 does not divide: layout (c); SeamlessM4T
    at its 16 heads and its vocabulary of 256,206, which 16 does not
    divide: the table and head cut on d): rank 0 of 256, the table its
    block."""
    from repro_torch.launch import dryrun
    monkeypatch.setitem(dryrun.SHAPES, "train_4k",
                        ShapeConfig("train_4k", 16, 32, "train"))
    cfg = get_config(arch).smoke()
    if arch == SEAMLESS:
        cfg = dataclasses.replace(cfg, num_heads=16, num_kv_heads=16,
                                  vocab_size=256_206)
    monkeypatch.setattr(dryrun, "get_config", lambda name: cfg)
    rec = dryrun.run_one(arch, "train_4k", False, str(tmp_path))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 256 and rec["tensor_parallel"] is True
    table = rec["specs"][0]["params"]["embed"]["table"]
    assert table == (["data", None, "model"] if arch == SEAMLESS
                     else ["data", "model", None])
    axes = shd.MeshAxes(("data",), "model", {"data": 16, "model": 16})
    low = steps.build_train_lowerable(cfg, dryrun.SHAPES["train_4k"], axes,
                                      mesh=axes)
    block = low.lower().outputs[0].params["embed"]["table"]
    assert tuple(block.shape) == ((1, 256_206, 256 // 16) if arch == SEAMLESS
                                  else (1, 512 // 16, 256))
