"""Deterministic peer-dropout schedule — the port of ``repro.elastic.schedule``.

The live mask for step ``t`` is a counter hash of ``(seed, t, peer_id)``
(the murmur3 finalizer): no RNG state, no wall clock, no collective.
Every peer and the single-device reference replay compute the same
32-bit arithmetic, so they agree on the mask bit for bit, with the JAX
package's too.  torch has no ``>>`` or ``>=`` for ``uint32`` on the CPU,
so the hash runs in int64 with every product kept to its low 32 bits.

Participation floor: a step whose hash (or trace row) leaves fewer than
``min_live`` peers gets the fallback mask instead, the first ``min_live``
peers live, so the sync never divides by an empty live set.
"""
from __future__ import annotations

import dataclasses

import torch

# murmur3 finalizer constants; the multiplies wrap modulo 2^32
_C1 = 0x9E3779B9
_C2 = 0x85EBCA6B
_C3 = 0xC2B2AE35
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Partial-participation schedule for the sync.

    ``rate`` is the per-peer per-step dropout probability of the counter
    hash (0: everyone is live, no hashing).  ``trace`` replaces the hash
    with a scripted 0/1 table of shape ``(T, n_peers)``, row ``step % T``
    (``elastic.chaos`` builds these).  ``min_live`` is the participation
    floor (see the module docstring).
    """

    rate: float = 0.0
    seed: int = 0x17E
    trace: tuple[tuple[int, ...], ...] | None = None
    min_live: int = 1

    def __post_init__(self):
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"dropout rate must be in [0, 1], got {self.rate}")
        if self.min_live < 1:
            raise ValueError("min_live must be >= 1 (the sync needs a live peer)")
        if self.trace is not None:
            rows = tuple(tuple(int(v) for v in row) for row in self.trace)
            if not rows or not rows[0]:
                raise ValueError("chaos trace must be a non-empty (T, n) table")
            width = len(rows[0])
            for r, row in enumerate(rows):
                if len(row) != width:
                    raise ValueError(
                        f"chaos trace row {r} has {len(row)} peers, row 0 has {width}")
                if any(v not in (0, 1) for v in row):
                    raise ValueError(f"chaos trace row {r} must be 0/1 entries")
            object.__setattr__(self, "trace", rows)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a · c mod 2^32`` for int64 ``a`` in [0, 2^32): the constant split
    in 16-bit halves keeps every product below 2^48."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _step_tensor(step, device) -> torch.Tensor:
    """``step`` (a Python int or a 0-d integer tensor) as an int64 scalar
    modulo 2^32, the JAX package's ``uint32`` cast."""
    if isinstance(step, torch.Tensor):
        return step.to(device=device, dtype=torch.int64) & _MASK32
    return torch.tensor(int(step) & _MASK32, dtype=torch.int64, device=device)


def _hash_mask(seed: int, step, n: int, rate: float, device=None) -> torch.Tensor:
    """(n,) float32 0/1 mask from the counter hash."""
    threshold = min(int(round(rate * (1 << 32))), (1 << 32) - 1)
    if threshold == 0:
        return torch.ones(n, dtype=torch.float32, device=device)
    peer = torch.arange(n, dtype=torch.int64, device=device)
    h = ((((seed & _MASK32) * _C1) & _MASK32)
         ^ _mul32(_step_tensor(step, device), _C2) ^ _mul32(peer, _C3))
    h = h ^ (h >> 16)
    h = _mul32(h, _C2)
    h = h ^ (h >> 13)
    h = _mul32(h, _C3)
    h = h ^ (h >> 16)
    return (h >= threshold).to(torch.float32)


def _device_of(step, device):
    if device is not None:
        return torch.device(device)
    return step.device if isinstance(step, torch.Tensor) else None


def live_mask(cfg: ElasticConfig, step, n: int, device=None) -> torch.Tensor:
    """The (n,) float32 live mask for ``step`` (1.0 = live, 0.0 = dropped),
    on ``device`` (default: ``step``'s if it is a tensor, else the CPU).

    ``step`` may be a Python int or a 0-d integer tensor.  The
    participation floor replaces a mask with too few live peers by the
    first ``min_live`` peers (see the module docstring).
    """
    device = _device_of(step, device)
    if cfg.trace is not None:
        table = torch.tensor(cfg.trace, dtype=torch.float32, device=device)
        if table.shape[1] != n:
            raise ValueError(f"chaos trace is for {table.shape[1]} peers, mesh has {n}")
        mask = table[_step_tensor(step, device) % table.shape[0]]
    else:
        mask = _hash_mask(cfg.seed, step, n, cfg.rate, device)
    floor = min(cfg.min_live, n)
    fallback = (torch.arange(n, device=device) < floor).to(torch.float32)
    return torch.where(torch.sum(mask) >= floor, mask, fallback)


def expected_live_fraction(cfg: ElasticConfig | None, n: int, start_step: int,
                           window: int) -> float:
    """Mean live fraction over ``[start_step, start_step + window)``: the
    schedule replayed on the host, which the adaptive controller budgets
    the next replan window against.  ``cfg=None`` (elastic off) is full
    participation."""
    if cfg is None or n <= 0:
        return 1.0
    window = max(int(window), 1)
    total = 0.0
    for s in range(int(start_step), int(start_step) + window):
        # jnp.mean's bits: the sum times the float32 1/n
        total += float(torch.sum(live_mask(cfg, s, n)) * (1.0 / n))
    return total / window
