"""Every random draw of the port, from one ``torch.Generator``.

The reference derives its randomness from ``jax.random`` keys
(``fold_in(step_key, t)`` split into W, gradient and server keys).  The
port cannot reproduce those bits, so all its draws go through one
:class:`Draws` object that the engine and the trainer are handed:

  * the link-failure uniforms behind W^t when ``p_fail > 0``;
  * the int8 codec's rounding noise (compressed gossip);
  * the server's K participant draws;
  * the data tokens;
  * the model's initial weights and the data distributions.

Methods that the engine calls take the step counter ``t``, so a test can
pass an object with the same methods that replays the reference's draws
for that step instead (see tests/test_torch_engine.py).  A sweep lattice
takes a :class:`SweepDraws`, whose engine draws have a leading run axis
and whose ``t`` is the (R,) array of per-run step counters.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Draws", "SweepDraws"]


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

    def codec_noise(self, t: int, n: int, d: int) -> torch.Tensor:
        """(n, d) U[0, 1) rounding noise of the int8 codec at step t.

        Drawn only by a codec that needs it, so an identity, bf16 or top-k
        run consumes exactly the draws of the uncompressed run, as the
        reference derives its codec key without a split
        (repro/core/flat.py:450-451)."""
        del t
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

    def codec_noise(self, t, n: int, d: int) -> torch.Tensor:
        if self.runs is None:
            return super().codec_noise(t, n, d).expand(self.r_runs, n, d)
        noise = torch.empty((self.r_runs, n, d), device=self.device)
        for r, run in enumerate(self.runs):
            noise[r] = run.codec_noise(t, n, d)
        return noise
