"""Every random draw of the port, from one ``torch.Generator``.

The reference derives its randomness from ``jax.random`` keys
(``fold_in(step_key, t)`` split into W, gradient and server keys).  The
port cannot reproduce those bits, so all its draws go through one
:class:`Draws` object that the engine and the trainer are handed:

  * the link-failure uniforms behind W^t when ``p_fail > 0``;
  * the int8 codec's rounding noise (compressed gossip);
  * the server's K participant draws;
  * the data tokens (of all agents, or of a population cohort);
  * the model's initial weights and the data distributions.

Methods that the engine calls take the step counter ``t``, so a test can
pass an object with the same methods that replays the reference's draws
for that step instead (see tests/test_torch_engine.py).  A sweep lattice
takes a :class:`SweepDraws`, whose engine draws have a leading run axis
and whose ``t`` is the (R,) array of per-run step counters, or a
:class:`RoundDraws`, which re-keys every run at every server round, as
the reference's figure drivers do with ``per_step_keys``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Draws", "SweepDraws", "RoundDraws"]


class Draws:
    """Random draws on ``device`` from one seeded generator."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    # -- engine draws (keyed by the step counter t) -------------------------

    def link_uniforms(self, t: int, n: int) -> torch.Tensor:
        """(n, n) U[0, 1) behind W^t's link failures at step t."""
        del t
        return self.uniform((n, n))

    def codec_noise(self, t: int, n: int, d: int,
                    leaf: int | None = None) -> torch.Tensor:
        """(n, d) U[0, 1) rounding noise of the int8 codec at step t.

        Drawn only by a codec that needs it, so an identity, bf16 or top-k
        run consumes exactly the draws of the uncompressed run, as the
        reference derives its codec key without a split
        (repro/core/flat.py:450-451).  The tree engine draws one block
        per leaf, ``leaf`` its position in jax.tree.flatten's order (the
        reference's ``fold_in(key_c, leaf)``, repro/core/compress.py:
        304-314); a generator's draws follow one another whatever it is."""
        del t, leaf
        return self.uniform((n, d))

    def participants(self, t: int, n: int, k: int) -> torch.Tensor:
        """(k,) agent indices, uniform with replacement, at step t."""
        del t
        return torch.randint(0, n, (k,), generator=self.generator,
                             device=self.device)

    def tokens(self, data, per_agent_batch: int, steps: int | None):
        """One federated batch (n, B, S), or ``steps`` of them stacked."""
        if steps is None:
            return data.sample(self, per_agent_batch)
        return torch.stack([data.sample(self, per_agent_batch)
                            for _ in range(steps)])

    def cohort_tokens(self, data, ids, per_agent_batch: int, steps: int,
                      round_idx: int) -> torch.Tensor:
        """``steps`` batches (steps, c, B, S) of the population cohort
        ``ids`` (numpy) in round ``round_idx``."""
        del round_idx
        agents = torch.from_numpy(np.asarray(ids, dtype=np.int64))
        if self.device.type == "cuda":
            # from pinned memory, asynchronously: a pageable upload would
            # wait for the round in flight on the device
            agents = agents.pin_memory().to(self.device, non_blocking=True)
        return torch.stack([data.sample_agents(self, agents, per_agent_batch)
                            for _ in range(steps)])

    # -- primitive draws ----------------------------------------------------

    def uniform(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, dtype=dtype,
                          device=self.device)

    def normal(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, dtype=dtype,
                           device=self.device)

    def truncated_normal(self, shape, lo: float = -2.0,
                         hi: float = 2.0) -> torch.Tensor:
        """Standard normal truncated to [lo, hi], f32."""
        out = torch.empty(shape, dtype=torch.float32, device=self.device)
        return torch.nn.init.trunc_normal_(out, 0.0, 1.0, lo, hi,
                                           generator=self.generator)

    def categorical(self, logits: torch.Tensor) -> torch.Tensor:
        """One index per row of ``logits`` (last dim), by Gumbel-max."""
        u = self.uniform(logits.shape, dtype=logits.dtype)
        return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)

    def gamma(self, alpha: float, shape) -> torch.Tensor:
        """Gamma(alpha, 1) variates in f64 (Marsaglia–Tsang; alpha < 1 by
        the U^(1/alpha) boost)."""
        boost = alpha < 1.0
        a = alpha + 1.0 if boost else alpha
        dd = a - 1.0 / 3.0
        c = 1.0 / math.sqrt(9.0 * dd)
        out = torch.empty(shape, dtype=torch.float64, device=self.device)
        flat = out.view(-1)
        todo = torch.arange(flat.numel(), device=self.device)
        while todo.numel():
            z = self.normal((todo.numel(),), torch.float64)
            v = (1.0 + c * z) ** 3
            u = self.uniform((todo.numel(),), torch.float64)
            ok = (v > 0) & (torch.log(u) < 0.5 * z * z + dd - dd * v
                            + dd * torch.log(v.clamp_min(1e-300)))
            flat[todo[ok]] = dd * v[ok]
            todo = todo[~ok]
        if boost:
            out = out * self.uniform(shape, torch.float64) ** (1.0 / alpha)
        return out

    def dirichlet(self, alpha: float, rows: int, dim: int) -> torch.Tensor:
        """(rows, dim) Dirichlet(alpha·1) draws, f32."""
        g = self.gamma(alpha, (rows, dim))
        return (g / g.sum(dim=-1, keepdim=True)).float()


class SweepDraws(Draws):
    """The draws of an R-run sweep lattice.

    The inherited primitives (and so the initial weights, the data
    distributions and the one shared token stream) come from ``seed``'s
    generator, as for a single run.  The engine draws gain a run axis:
    ``link_uniforms`` gives (R, n, n) and ``participants`` (R, K).  With
    ``per_run`` (the ``seed`` axis) run r draws them from a generator of
    its own, seeded from (seed, r); otherwise (the ``h`` and ``topology``
    axes) one draw is broadcast to every run, so the swept axis is the
    only difference between runs (repro/launch/train.py:274-280).  So is
    the int8 codec's noise, (R, n, d): per run, or one (n, d) draw
    expanded over the runs without a copy.
    """

    def __init__(self, seed: int, device, r_runs: int, per_run: bool):
        super().__init__(seed, device)
        self.r_runs = r_runs
        self.runs = [Draws(np.random.SeedSequence([seed, r]).generate_state(
            1)[0], device) for r in range(r_runs)] if per_run else None

    def link_uniforms(self, t, n: int) -> torch.Tensor:
        if self.runs is None:
            return super().link_uniforms(t, n).expand(self.r_runs, n, n)
        return torch.stack([d.link_uniforms(t, n) for d in self.runs])

    def participants(self, t, n: int, k: int) -> torch.Tensor:
        if self.runs is None:
            return super().participants(t, n, k).expand(self.r_runs, k)
        return torch.stack([d.participants(t, n, k) for d in self.runs])

    def codec_noise(self, t, n: int, d: int,
                    leaf: int | None = None) -> torch.Tensor:
        if self.runs is None:
            return super().codec_noise(t, n, d, leaf).expand(self.r_runs, n,
                                                             d)
        noise = torch.empty((self.r_runs, n, d), device=self.device)
        for r, run in enumerate(self.runs):
            noise[r] = run.codec_noise(t, n, d, leaf)
        return noise


class RoundDraws:
    """Per-round re-keyed draws of an R-run lattice, made on the host and
    moved to the device once: the port's counterpart of the reference's
    ``per_step_keys`` (repro/core/sweep.py:330-333).

    Run r at step t (counted from 1) draws from the streams keyed by
    (seed, ``seed_ids[r]``, (t − 1) // ``h[r]``), the round of t under run
    r's H.  A round's stream gives its h[r] steps at once, in step order:
    the server's (h, K) participants, the (h, n, n) link uniforms (built
    with ``link_failures``) and, through :meth:`minibatch_indices`, the
    (h, n, m) minibatch rows (the reference's per-round ``randint(kb, (h,
    n, m))``, benchmarks/common.py:120-146).  Runs with the same seed id
    and the same H therefore see the same draws whatever their graph or
    algorithm: the common random numbers of fig4's comparisons.  The
    streams are numpy generators, so a run on the card and a run on the
    CPU see the same draws.  ``t_steps`` bounds the horizon.
    """

    _STREAMS = {"batch": 0, "server": 1, "links": 2}

    def __init__(self, seed: int, seed_ids, h, t_steps: int, *, n: int,
                 k: int, device, link_failures: bool = False):
        self.seed = int(seed)
        self.seed_ids = np.asarray(seed_ids, dtype=np.int64)
        self.h = np.asarray(h, dtype=np.int64)
        if self.seed_ids.shape != self.h.shape or self.h.ndim != 1:
            raise ValueError(f"seed_ids {self.seed_ids.shape} and h "
                             f"{self.h.shape} must be one entry per run")
        self.t_steps, self.n, self.k = int(t_steps), int(n), int(k)
        self.device = torch.device(device)
        self._participants = self._table(
            "server", lambda g, h: g.integers(0, n, (h, k)))
        self._uniforms = self._table(
            "links", lambda g, h: g.random((h, n, n), dtype=np.float32)) \
            if link_failures else None

    @property
    def r_runs(self) -> int:
        return len(self.h)

    def _table(self, stream: str, draw) -> torch.Tensor:
        """(T, R, ...) on the device: every run's rounds' blocks, cut to
        ``t_steps``, drawn once per distinct (seed id, H)."""
        out = None
        for sid, h in sorted(set(zip(self.seed_ids.tolist(),
                                     self.h.tolist()))):
            runs = np.flatnonzero((self.seed_ids == sid) & (self.h == h))
            blocks = np.concatenate([
                draw(np.random.default_rng(np.random.SeedSequence(
                    (self.seed, sid, j, self._STREAMS[stream]))), h)
                for j in range(-(-self.t_steps // h))])[:self.t_steps]
            if out is None:
                out = np.empty((self.t_steps, self.r_runs)
                               + blocks.shape[1:], blocks.dtype)
            out[:, runs] = blocks[:, None]
        return torch.from_numpy(out).to(self.device)

    def _at(self, table: torch.Tensor, t) -> torch.Tensor:
        """Row t − 1 of every run (a view when the runs are in step)."""
        s = np.asarray(t, dtype=np.int64) - 1
        if (s == s[0]).all():
            return table[int(s[0])]
        return table[torch.as_tensor(s, device=self.device),
                     torch.arange(self.r_runs, device=self.device)]

    def minibatch_indices(self, m_batch: int, m_rows: int) -> torch.Tensor:
        """(T, R, n, m) int64 minibatch rows on the device: step s of run r
        takes rows ``[s, r]`` of each agent's M = ``m_rows`` rows."""
        return self._table("batch", lambda g, h: g.integers(
            0, m_rows, (h, self.n, m_batch)))

    def participants(self, t, n: int, k: int) -> torch.Tensor:
        """(R, K) server draws of step t (the (R,) per-run counters)."""
        if (n, k) != (self.n, self.k):
            raise ValueError(f"RoundDraws made for n={self.n}, K={self.k}, "
                             f"asked for n={n}, K={k}")
        return self._at(self._participants, t)

    def link_uniforms(self, t, n: int) -> torch.Tensor:
        """(R, n, n) link-failure uniforms of step t."""
        if self._uniforms is None:
            raise ValueError("RoundDraws made without link_failures")
        if n != self.n:
            raise ValueError(f"RoundDraws made for n={self.n}, asked for "
                             f"n={n}")
        return self._at(self._uniforms, t)
