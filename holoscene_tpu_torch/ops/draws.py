"""Random draws by weight that give the same indices on every run: MCMC's
relocation targets (models/gaussians_free.py::mcmc_relocate) and Stage 3's
pixel draws (training/stage3.py::Stage3Runner._draw). The callers look
the function up on this module at call time (`draws.draw_by_weight`), so
a diagnosis can swap the draw for both at once."""

from __future__ import annotations

import torch


@torch.no_grad()
def draw_by_weight(weights, n: int, generator=None) -> torch.Tensor:
    """n indices into weights [m] (>= 0), drawn with replacement with
    probability proportional to the weights, by inverse CDF on the
    generator's device. The CDF is an int64 prefix sum of the weights
    scaled to 2^32 at their largest and rounded: integer sums are exact in
    any order, so the draw is one function of the weights and the
    generator's state. torch.multinomial's float prefix sum is not on the
    card (its scan adds in an order that varies from run to run), and a
    last-bit change in it moves a draw to a neighbouring slot. All-zero
    weights draw index 0 every time (callers pass uniform weights where
    nothing is to be drawn)."""
    dev = generator.device if generator is not None else weights.device
    w = weights.detach().to(dev, torch.float64)
    top = w.max()
    scale = 2.0 ** 32 / torch.where(top > 0, top, torch.ones_like(top))
    cdf = torch.cumsum(torch.round(w * scale).long(), 0)
    u = torch.rand(n, generator=generator, device=dev, dtype=torch.float64)
    r = torch.minimum((u * cdf[-1]).long(), cdf[-1] - 1)
    return torch.searchsorted(cdf, r, right=True)
