"""Roofline model: three terms (compute / memory / collective) per traced cell.

The port of `repro.launch.roofline`.  The constants are one NVIDIA H100
SXM5 80GB's data-sheet figures at its full 700 W power limit (what
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints as
"NVIDIA H100 80GB HBM3, 700.00 W"): 989.4 TFLOP/s dense bf16 and 3.35 TB/s
of HBM3.  A card capped below 700 W runs slower than these say.

The collective term models one link per card.  A production mesh of 256
ranks spans 32 nodes of 8 cards, so a ring over a mesh axis crosses nodes,
and the conservative single link is the node's InfiniBand NDR port, 400
Gb/s = 50e9 B/s a card (`LINK_BW`).  Inside a node a ring would run on
NVLink 4 at 450e9 B/s a direction, which the term does not use.

`dryrun` takes the flops per device from the trace of one step on each
rank's local shards, so the terms divide by one card's peaks directly.
The collectives are the ones the traced step ran (`record`: a
`dryrun.StepTrace`'s list of (kind, result bytes, group size)), converted
to wire bytes per device with the reference's ring factors, as functions of
the *result* bytes S and the group size n:

    all-reduce        2·S·(n-1)/n
    all-gather        S·(n-1)/n      (the result is the gathered buffer)
    reduce-scatter    S·(n-1)        (the result is the shard)
    all-to-all        S·(n-1)/n
    collective-permute S

collective_term = wire_bytes / LINK_BW.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

PEAK_FLOPS = 989.4e12   # dense bf16 FLOP/s, one H100 SXM5 80GB at 700 W
HBM_BW = 3.35e12        # HBM3 bytes/s, one H100 SXM5 80GB
LINK_BW = 50e9          # bytes/s a card: InfiniBand NDR, 400 Gb/s (across nodes)

_RING_FACTOR = {
    "all-reduce": lambda s, n: 2.0 * s * (n - 1) / max(n, 1),
    "all-gather": lambda s, n: 1.0 * s * (n - 1) / max(n, 1),
    "reduce-scatter": lambda s, n: 1.0 * s * (n - 1),
    "all-to-all": lambda s, n: 1.0 * s * (n - 1) / max(n, 1),
    "collective-permute": lambda s, n: 1.0 * s,
}

# torch.distributed's collectives (the functional ops DTensor runs and the
# c10d ops behind `dist.*`) -> the reference's HLO kinds
KINDS = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "permute_tensor": "collective-permute",
}


def collective_stats(record, default_group: int = 1) -> dict:
    """Per-kind result / wire byte sums of the collectives a traced step
    ran: `record` holds one (kind, result bytes, group size or None)
    per collective, kind a key of `KINDS` or a reference kind; a missing
    group size is `default_group`.  The dict the reference's HLO sweep
    returns: {"ops": {kind: {"count", "result_bytes", "wire_bytes"}},
    "wire_bytes_per_device"}."""
    ops: dict[str, dict] = {}
    wire_total = 0.0
    for kind, rbytes, n in record:
        kind = KINDS.get(kind, kind)
        n = default_group if n is None else n
        wire = _RING_FACTOR[kind](rbytes, n)
        rec = ops.setdefault(kind, {"count": 0, "result_bytes": 0, "wire_bytes": 0.0})
        rec["count"] += 1
        rec["result_bytes"] += rbytes
        rec["wire_bytes"] += wire
        wire_total += wire
    return {"ops": ops, "wire_bytes_per_device": wire_total}


@dataclass
class Roofline:
    flops_per_device: float
    hlo_bytes_per_device: float      # every op's operands + results -- pre-fusion UPPER bound
    min_bytes_per_device: float      # arguments + outputs traffic -- LOWER bound
    wire_bytes_per_device: float
    compute_s: float
    memory_upper_s: float
    memory_s: float                  # from the lower bound; used for the verdict
    collective_s: float
    bound: str
    model_flops: float
    useful_ratio: float

    def to_dict(self):
        return asdict(self)


def roofline(cost: dict, coll: dict, n_devices: int, model_flops: float,
             min_bytes: float = 0.0) -> Roofline:
    """Three-term roofline.  The memory term uses the analytic lower bound
    (inputs read once + outputs written once); `cost`'s "bytes accessed"
    (the trace's every op's operands and results, before any fusion, where
    the reference's compiler counts its own) gives the upper term, reported
    beside it."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    wire = float(coll["wire_bytes_per_device"])
    terms = {
        "compute": flops / PEAK_FLOPS,
        "memory": min_bytes / HBM_BW,
        "collective": wire / LINK_BW,
    }
    bound = max(terms, key=terms.get)
    useful = model_flops / max(flops * n_devices, 1.0)
    return Roofline(
        flops_per_device=flops,
        hlo_bytes_per_device=byts,
        min_bytes_per_device=min_bytes,
        wire_bytes_per_device=wire,
        compute_s=terms["compute"],
        memory_upper_s=byts / HBM_BW,
        memory_s=terms["memory"],
        collective_s=terms["collective"],
        bound=bound,
        model_flops=model_flops,
        useful_ratio=useful,
    )


def model_flops_for(cfg, shape) -> float:
    """6·N_active·D for training, 2·N_active·D for inference."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n_active * tokens
