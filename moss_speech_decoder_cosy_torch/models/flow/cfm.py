"""Conditional flow matching with a fixed-step Euler solver, after the JAX
package's ``models/flow/cfm.py`` (reference flow/flow_matching.py:
158-230), and the OT-CFM training loss.

- The noise is a fixed standard-normal buffer from
  ``np.random.RandomState(0)``, sliced to length, so streaming windows and
  the offline pass see identical z, and this package draws the same values
  as the JAX package.
- The Euler carry, the CFG combine and the t/dt schedule stay in f32
  (``solver_dtype="float32"``); the estimator runs in ``estimator_dtype``
  or the dtype of ``mu``.
- ``compute_loss`` takes its random draws as a ``CFMDraws`` (from a
  ``torch.Generator``, or the JAX package's own draws in the tests).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .estimator import CausalConditionalDecoder
from ...utils.config import CFMConfig, EstimatorConfig


@functools.lru_cache(maxsize=None)
def _fixed_noise(max_len: int, dim: int) -> np.ndarray:
    """Deterministic (1, max_len, dim) standard normal buffer."""
    rng = np.random.RandomState(0)
    return rng.standard_normal((1, max_len, dim)).astype(np.float32)


def t_span_cosine(n_timesteps: int) -> np.ndarray:
    t = np.linspace(0.0, 1.0, n_timesteps + 1)
    return (1.0 - np.cos(t * 0.5 * np.pi)).astype(np.float32)


@dataclasses.dataclass
class CFMDraws:
    """The OT-CFM loss's draws: ``t`` (B,) uniform in [0, 1) before the
    t-scheduler, ``z`` (B, T, D) standard normal, ``cfg`` (B,) uniform in
    [0, 1) (a row's conditioning is dropped where it is <=
    ``training_cfg_rate``)."""
    t: torch.Tensor
    z: torch.Tensor
    cfg: torch.Tensor

    @classmethod
    def draw(cls, shape: Tuple[int, int, int], generator: torch.Generator,
             device) -> "CFMDraws":
        b = shape[0]
        return cls(t=torch.rand(b, generator=generator, device=device),
                   z=torch.randn(shape, generator=generator, device=device),
                   cfg=torch.rand(b, generator=generator, device=device))


class CausalConditionalCFM(nn.Module):
    """``estimator``: the velocity network, by default the U-Net of
    ``estimator_cfg`` (the DiT variant passes its own, ``dit.py``)."""

    def __init__(self, cfg: CFMConfig, estimator_cfg: EstimatorConfig,
                 estimator: Optional[nn.Module] = None):
        super().__init__()
        self.cfg = cfg
        self.estimator = (estimator if estimator is not None
                          else CausalConditionalDecoder(estimator_cfg))
        self._noise = {}
        self._consts = {}    # the KV steps' solver constants, per device

    def _z(self, t: int, d: int, device) -> torch.Tensor:
        key = (d, str(device))
        if key not in self._noise:
            self._noise[key] = torch.from_numpy(
                _fixed_noise(self.cfg.max_noise_len, d)).to(device)
        return self._noise[key][:, :t]

    def euler_step(self, x: torch.Tensor, t_cur: float, dt: float,
                   mu_in: torch.Tensor, valid_in: torch.Tensor,
                   spks_in: torch.Tensor, cond_in: torch.Tensor,
                   streaming: bool) -> torch.Tensor:
        """One Euler step with the CFG batch-of-2; ``x`` in the solver
        dtype, the estimator in its compute dtype."""
        b = x.shape[0]
        cd = (getattr(torch, self.cfg.estimator_dtype)
              if self.cfg.estimator_dtype else mu_in.dtype)
        x_in = torch.cat([x, x], dim=0).to(cd)
        t_in = torch.full((2 * b,), t_cur, dtype=cd, device=x.device)
        dphi = self.estimator(x_in, valid_in, mu_in.to(cd), t_in,
                              spks_in.to(cd), cond_in.to(cd),
                              streaming=streaming).to(x.dtype)
        # device fills, not uploads, so a captured step can run them
        rate = torch.full((), self.cfg.inference_cfg_rate, dtype=x.dtype,
                          device=x.device)
        dphi = (1.0 + rate) * dphi[:b] - rate * dphi[b:]
        return x + torch.full((), dt, dtype=x.dtype, device=x.device) * dphi

    def forward(self, mu: torch.Tensor, valid: torch.Tensor,
                spks: torch.Tensor, cond: torch.Tensor,
                streaming: bool = False,
                temperature: float = 1.0) -> torch.Tensor:
        """mu (B, T, n_mel) -> mel (B, T, n_mel) f32 by solving the ODE."""
        c = self.cfg
        b, t, d = mu.shape
        sd = torch.float32 if c.solver_dtype == "float32" else mu.dtype
        z = self._z(t, d, mu.device).expand(b, t, d).to(sd) * temperature

        if c.t_scheduler == "cosine":
            t_span = t_span_cosine(c.n_timesteps)
        else:
            t_span = np.linspace(0, 1, c.n_timesteps + 1, dtype=np.float32)
        dts = np.diff(t_span)

        mu_in = torch.cat([mu, torch.zeros_like(mu)], dim=0)
        spks_in = torch.cat([spks, torch.zeros_like(spks)], dim=0)
        cond_in = torch.cat([cond, torch.zeros_like(cond)], dim=0)
        valid_in = torch.cat([valid, valid], dim=0)
        x = z
        for t_i, dt_i in zip(t_span[:-1], dts):
            x = self.euler_step(x, float(t_i), float(dt_i), mu_in, valid_in,
                                spks_in, cond_in, streaming)
        return x.float()

    def compute_loss(self, x1: torch.Tensor, valid: torch.Tensor,
                     mu: torch.Tensor, spks: torch.Tensor,
                     cond: torch.Tensor, draws: CFMDraws,
                     streaming: bool = True, reduce=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The OT-CFM loss (flow_matching.py:158-196): x1 the target mel
        (B, T, n_mel), valid bool (B, T).  Returns (the masked MSE of the
        predicted flow, the flow sample y).  ``reduce`` (a data-parallel
        rank's): the sum over the ranks of the mask's count, so the ranks'
        losses add up to the masked mean over the global batch (the JAX
        package divides by the count of the whole sharded batch)."""
        c = self.cfg
        d = x1.shape[-1]
        tt = draws.t.to(x1.dtype)[:, None, None]
        if c.t_scheduler == "cosine":
            tt = 1.0 - torch.cos(tt * 0.5 * np.pi)
        z = draws.z.to(x1.dtype)
        y = (1.0 - (1.0 - c.sigma_min) * tt) * z + tt * x1
        u = x1 - (1.0 - c.sigma_min) * z
        if c.training_cfg_rate > 0:
            keep = (draws.cfg > c.training_cfg_rate).to(x1.dtype)
            mu = mu * keep[:, None, None]
            spks = spks * keep[:, None]
            cond = cond * keep[:, None, None]
        pred = self.estimator(y, valid, mu, tt[:, 0, 0], spks, cond,
                              streaming=streaming)
        m = valid[..., None].to(x1.dtype)
        den = torch.sum(m) * d
        if reduce is not None:
            den = reduce(den.detach())
        loss = torch.sum(((pred - u) * m) ** 2) / den
        return loss, y
