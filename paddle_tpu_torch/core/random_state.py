"""Global random state (counterpart of ``paddle_tpu/core/random_state.py``).

Paddle keeps a stateful Philox generator a device, reseeded by
``paddle.seed``.  The port keeps one ``torch.Generator`` a device, made on
first use and seeded from the last ``seed`` (0 by default); every random
op draws from the generator of the device it writes to (``generator``).
``seed`` reseeds every generator made so far and those made later.

The reference's ``split_key`` and ``trace_key_provider`` hand out JAX PRNG
keys, a fresh subkey an op and a traced key source under graph capture.
A torch generator is itself the stream of random numbers, so neither has
a counterpart here.  Never compare random values across the packages: JAX's
threefry and torch's Philox differ."""

from __future__ import annotations

import threading
from typing import Dict

import torch

__all__ = ["seed", "get_rng_state", "set_rng_state", "default_seed",
           "current_seed", "generator"]

_DEFAULT_SEED = 0
_lock = threading.Lock()
_seed = _DEFAULT_SEED
_GENERATORS: Dict[torch.device, torch.Generator] = {}


def _key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def generator(device="cpu") -> torch.Generator:
    """The generator of ``device``, made and seeded on first use."""
    dev = _key(device)
    with _lock:
        gen = _GENERATORS.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_seed)
            _GENERATORS[dev] = gen
        return gen


def seed(s: int) -> int:
    """paddle.seed: reseed every device's generator."""
    global _seed
    with _lock:
        _seed = int(s)
        for gen in _GENERATORS.values():
            gen.manual_seed(_seed)
    return _seed


def default_seed() -> int:
    return _DEFAULT_SEED


def current_seed() -> int:
    """The integer last passed to :func:`seed`."""
    return _seed


def get_rng_state(device="cpu") -> torch.Tensor:
    """The state of ``device``'s generator (a uint8 tensor)."""
    return generator(device).get_state()


def set_rng_state(state, device="cpu") -> None:
    generator(device).set_state(state)
