"""Annealing schedules (counterpart of multimodal_dmm_tpu/ops/schedules.py)."""


def anneal(min_val, max_val, t, anneal_len):
    """Linear annealing from ``min_val`` to ``max_val`` over
    ``anneal_len`` steps; gives the trainer's per-batch KLD multiplier."""
    if t >= anneal_len:
        return max_val
    return (max_val - min_val) * t / anneal_len + min_val
