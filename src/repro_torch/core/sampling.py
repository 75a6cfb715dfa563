"""Gradient-based sampling (paper §2.4): SGB, GOSS and MVS.

Counterpart of `repro.core.sampling`. Every method returns a (keep_mask,
weight) pair over the full row set. The in-core engine multiplies the
gradients by ``where(keep, weight, 0)``; the sampled engine (Alg. 7)
compacts the kept rows of every page into one device page
(`GradientBooster._build_tree_sampled`).

MVS (eq. 9): p_i = min(ĝ_i / μ, 1) with ĝ_i = sqrt(g_i² + λ h_i²) and μ the
exact threshold solving Σ p_i = f·n (Ibragimov & Gusev 2019). Kept rows are
reweighted 1/p_i so gradient statistics stay unbiased.

Draws come from the caller's `torch.Generator`, on the gradients' device;
nothing reads the global random state. The deterministic parts (λ, μ, the
MVS probabilities and weights, the GOSS threshold, top set and weights)
follow the reference's f32 arithmetic; the random streams differ from
``jax.random``'s.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    method: str = "none"  # none | uniform (SGB) | goss | mvs
    f: float = 1.0  # overall sampling ratio (uniform & mvs)
    goss_a: float = 0.2  # GOSS top-gradient fraction
    goss_b: float = 0.1  # GOSS random fraction of the remainder
    mvs_lambda: float | None = None  # None -> estimate from (Σg/Σh)²

    def __post_init__(self):
        if self.method not in ("none", "uniform", "goss", "mvs"):
            raise ValueError(f"unknown sampling method {self.method!r}")
        if not (0.0 < self.f <= 1.0):
            raise ValueError("sampling ratio f must be in (0, 1]")


def estimate_mvs_lambda(g: Tensor, h: Tensor) -> Tensor:
    """Paper §2.4.3: λ estimated from the squared mean of the initial leaf value."""
    return (torch.sum(g) / torch.clamp(torch.sum(h), min=1e-12)) ** 2


def _uniform_sample(generator: torch.Generator, g: Tensor, f: float):
    keep = torch.rand(g.shape[0], generator=generator, device=g.device) < f
    return keep, torch.ones_like(g)


def _goss_sample(generator: torch.Generator, g: Tensor, h: Tensor, a: float, b: float):
    """GOSS (§2.4.2): keep top-a·n by |ĝ|, sample b·n of the rest, scale by (1-a)/b."""
    n = g.shape[0]
    mag = torch.abs(g)
    k = max(int(a * n), 1)
    threshold = torch.sort(mag).values[n - k]  # k-th largest
    top = mag >= threshold
    rest_prob = b / max(1.0 - a, 1e-12)
    rand_keep = torch.rand(n, generator=generator, device=g.device) < rest_prob
    keep = top | (~top & rand_keep)
    weight = torch.where(top, 1.0, (1.0 - a) / b).to(g.dtype)
    return keep, weight


SCAN_ROW = 1024


def prefix_sums(x: Tensor) -> Tensor:
    """Inclusive prefix sums of a 1-D tensor, the same bits on every call.

    A 1-D ``torch.cumsum`` on CUDA is a single-pass scan whose tiles take
    their predecessors' sums in an order set by timing, so its float sums
    change from call to call, and with them μ, every MVS weight and the
    trees. A scan along the rows of a 2-D tensor has a fixed order. So the
    values are laid out in rows of ``SCAN_ROW`` (at least two rows: a single
    row is the 1-D case again), each row is scanned, and the row totals are
    scanned the same way and added on as each row's carry.
    """
    n = x.shape[0]
    if n <= SCAN_ROW:
        rows = x.new_zeros(2, SCAN_ROW)
        rows[0, :n] = x
        return torch.cumsum(rows, 1)[0, :n]
    n_rows = -(-n // SCAN_ROW)
    flat = x.new_zeros(n_rows * SCAN_ROW)
    flat[:n] = x
    local = torch.cumsum(flat.view(n_rows, SCAN_ROW), 1)
    carry = x.new_zeros(n_rows)
    carry[1:] = prefix_sums(local[:-1, -1])
    return (local + carry[:, None]).view(-1)[:n]


def mvs_threshold(g_hat: Tensor, sample_size: Tensor | float) -> Tensor:
    """Exact MVS threshold μ s.t. Σ min(ĝ_i/μ, 1) = sample_size.

    Sort descending; with k rows "protected" (p=1), μ_k = (Σ_{i>k} ĝ_i)/(s-k).
    The valid k is the one with ĝ_(k) ≥ μ_k (protected rows really have p≥1)
    and ĝ_(k+1) ≤ μ_k. Vectorised search over all k, in f32; the suffix
    sums come from `prefix_sums`, so μ has the same bits on every call.
    """
    n = g_hat.shape[0]
    dev = g_hat.device
    s = torch.as_tensor(sample_size, dtype=torch.float32, device=dev)
    sorted_desc = torch.flip(torch.sort(g_hat).values, (0,)).to(torch.float32)
    # suffix[k] = Σ_{i>=k} sorted[i], summed from the smallest up
    suffix = torch.flip(prefix_sums(torch.flip(sorted_desc, (0,))), (0,))
    ks = torch.arange(n, dtype=torch.float32, device=dev)
    denom = torch.clamp(s - ks, min=1e-12)
    mu_k = suffix / denom  # μ when the top-k rows are protected
    inf = torch.full((1,), float("inf"), dtype=torch.float32, device=dev)
    prev = torch.cat([inf, sorted_desc[:-1]])
    valid = (prev >= mu_k) & (sorted_desc <= mu_k) & (ks < s)
    # the first valid k (there is always one when 0 < s <= n)
    k_idx = torch.argmax(valid.to(torch.uint8))
    return torch.where(valid.any(), mu_k[k_idx], torch.max(g_hat))


def mvs_probabilities(g: Tensor, h: Tensor, f: float, lam: Tensor) -> Tensor:
    """Each row's keep probability p_i = clip(ĝ_i / μ, 0, 1) (eq. 9)."""
    g_hat = torch.sqrt(g * g + lam * (h * h))
    mu = mvs_threshold(g_hat, f * g.shape[0])
    return torch.clamp(g_hat / torch.clamp(mu, min=1e-30), 0.0, 1.0)


def _mvs_sample(generator: torch.Generator, g: Tensor, h: Tensor, f: float, lam: Tensor):
    p = mvs_probabilities(g, h, f, lam)
    keep = torch.rand(g.shape[0], generator=generator, device=g.device) < p
    weight = 1.0 / torch.clamp(p, min=1e-12)
    return keep, weight


def sample(
    generator: torch.Generator, g: Tensor, h: Tensor, cfg: SamplingConfig
) -> tuple[Tensor, Tensor]:
    """Dispatch to the configured sampler; returns (keep_mask, weight)."""
    if cfg.method == "none" or cfg.f >= 1.0 and cfg.method == "uniform":
        return torch.ones(g.shape, dtype=torch.bool, device=g.device), torch.ones_like(g)
    if cfg.method == "uniform":
        return _uniform_sample(generator, g, cfg.f)
    if cfg.method == "goss":
        return _goss_sample(generator, g, h, cfg.goss_a, cfg.goss_b)
    if cfg.method == "mvs":
        lam = (
            estimate_mvs_lambda(g, h)
            if cfg.mvs_lambda is None
            else torch.tensor(cfg.mvs_lambda, dtype=torch.float32, device=g.device)
        )
        return _mvs_sample(generator, g, h, cfg.f, lam)
    raise ValueError(cfg.method)
