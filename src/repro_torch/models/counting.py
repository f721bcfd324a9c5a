"""Analytic parameter counts (for MODEL_FLOPS = 6·N·D roofline ratios).

The port of `repro.models.counting`: total counts come from the real init
run on the meta device (shapes only, nothing allocated).  MoE active counts
subtract the routed experts a token does not select.
"""
from __future__ import annotations

import math


def _abstract_params(cfg) -> dict:
    from .lm import LM  # local import to avoid a cycle
    return LM(cfg, device="meta").init(None)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(cfg) -> int:
    return sum(math.prod(leaf.shape) for leaf in _leaves(_abstract_params(cfg)))


def active_param_count(cfg) -> int:
    """Params touched per token: total minus the routed experts not selected."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_expert_ff
    inactive = (m.n_routed - m.top_k) * per_expert * (cfg.n_layers - m.n_dense_layers)
    return total - inactive
