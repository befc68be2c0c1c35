"""A model's parameters and BatchNorm statistics, made from the seed on the
device in one draw.

The names, shapes and initializers come from the plain reference's
``state_specs``, so the program and the reference are handed the same
tensors and neither makes them. One normal draw of every random leaf's
size on the card's generator, sliced and scaled leaf by leaf.
"""

from __future__ import annotations

import math

import torch

RANDOM_INITS = ("fan_in", "linear", "head")


def leaf_std(init: str, shape) -> float:
    if init == "fan_in":
        return math.sqrt(1.0 / math.prod(shape[:-1]))
    if init == "linear":
        return math.sqrt(1.0 / shape[-1])
    if init == "head":
        return 0.01
    raise ValueError(init)


def make_state(specs, seed: int, device, random_stats: bool = False) -> dict:
    """``{name: float32 tensor}`` for every ``(name, shape, init)`` of
    ``specs``. ``random_stats`` draws BatchNorm running statistics (means
    of std 0.1, variances of e^N(0, 0.2^2)) in place of their initial
    zeros and ones, as a trained model's would differ from them."""
    drawn = [s for s in specs if s[2] in RANDOM_INITS
             or (random_stats and s[2].startswith("stat_"))]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=generator, device=device)
    state, at = {}, 0
    for name, shape, init in specs:
        n = math.prod(shape)
        if init in RANDOM_INITS:
            state[name] = flat[at:at + n].view(shape) * leaf_std(init, shape)
            at += n
        elif random_stats and init == "stat_mean":
            state[name] = flat[at:at + n].view(shape) * 0.1
            at += n
        elif random_stats and init == "stat_var":
            state[name] = torch.exp(flat[at:at + n].view(shape) * 0.2)
            at += n
        elif init in ("ones", "stat_var"):
            state[name] = torch.ones(shape, device=device)
        elif init in ("zeros", "stat_mean"):
            state[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
    return state
