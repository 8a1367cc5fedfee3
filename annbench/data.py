"""The corpus and the query pool of a configuration, drawn from ``--seed``.

Two distributions, named by a configuration's ``data.distribution``:

* ``gaussian``: per-coordinate N(0, 1) vectors, a vector of squared norm
  under 1e-7 drawn again (the reference's ``vec_generator``,
  src/randomgeometry.h:73-96, as ``data/loader.generate_synthetic`` of the
  program draws it);
* ``clustered``: the hardened mixture of ``data/loader.
  generate_synthetic_clustered`` of the program: Zipf-ish cluster masses
  ``(rank + 3)^-0.6``, lognormal per-axis (sigma 0.45) and per-cluster
  (sigma 0.35) spreads; queries from the same mixture at 1.5x the spread,
  and a tenth of them between two clusters.

The parameters are the program's; the draws are not: everything is drawn on
``device`` by one ``torch.Generator`` in a few large calls, so a million
rows take milliseconds, and the same seed gives the same arrays.
"""

from __future__ import annotations

import torch

EPS = 1e-7


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _gaussian(count: int, d: int, g: torch.Generator, device) -> torch.Tensor:
    out = torch.randn((count, d), generator=g, device=device)
    while True:
        bad = torch.nonzero((out * out).sum(1) < EPS).flatten()
        if bad.numel() == 0:
            return out
        out[bad] = torch.randn((bad.numel(), d), generator=g, device=device)


class _Mixture:
    """The clustered mixture's parameters, drawn once per seed."""

    def __init__(self, p: dict, d: int, g: torch.Generator, device):
        c = int(p.get("clusters", 1000))
        self.sigma = float(p.get("sigma", 0.3))
        self.g, self.device = g, device
        self.centers = torch.randn((c, d), generator=g, device=device)
        mass = (torch.arange(c, device=device, dtype=torch.float64) + 3.0) ** -0.6
        self.mass = (mass / mass.sum()).float()
        self.axis = torch.exp(0.45 * torch.randn((c, d), generator=g, device=device))
        self.clus = torch.exp(0.35 * torch.randn((c, 1), generator=g, device=device))

    def draw(self, count: int, spread: float = 1.0) -> torch.Tensor:
        which = torch.multinomial(self.mass, count, replacement=True, generator=self.g)
        noise = torch.randn((count, self.centers.shape[1]), generator=self.g, device=self.device)
        return self.centers[which] + (self.sigma * spread) * self.clus[which] * self.axis[which] * noise

    def between(self, count: int) -> torch.Tensor:
        c, d = self.centers.shape
        a = torch.randint(0, c, (count,), generator=self.g, device=self.device)
        b = torch.randint(0, c, (count,), generator=self.g, device=self.device)
        t = 0.25 + 0.5 * torch.rand((count, 1), generator=self.g, device=self.device)
        noise = torch.randn((count, d), generator=self.g, device=self.device)
        return self.centers[a] * t + self.centers[b] * (1.0 - t) + self.sigma * noise


def make(data: dict, pool: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(corpus (n, d), pool (pool, d))``, float32 on ``device``."""
    n, d = int(data["n"]), int(data["d"])
    g = generator(seed, device)
    kind = data["distribution"]
    if kind == "gaussian":
        return _gaussian(n, d, g, device), _gaussian(pool, d, g, device)
    if kind == "clustered":
        mix = _Mixture(data, d, g, device)
        x = mix.draw(n)
        m_mix = pool // 10
        q = torch.cat([mix.draw(pool - m_mix, spread=1.5), mix.between(m_mix)])
        # every call of the loop gets its share of the between-cluster queries
        return x, q[torch.randperm(pool, generator=g, device=device)]
    raise ValueError(f"unknown distribution {kind!r}")
