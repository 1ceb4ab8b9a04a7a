"""Behavior system (port of ``repro.core.behaviors``).

A behavior reads the step context and returns effects — channel updates,
staged births, death marks, substance secretion — that the engine merges
and commits at the end of the iteration. Its base mask is ``ctx.owned``,
never ``pool.alive``. Every per-agent draw goes through :mod:`rand`
(capacity-stable threefry streams, bit-exact with the reference).

The catalogue of the paper's five benchmark simulations:
  GrowDivide          cell proliferation / oncology (create agents)
  RandomWalk          epidemiology / oncology (random movement)
  Infection           epidemiology (SIR over spatial neighbors)
  Chemotaxis          cell clustering (move up the substance gradient)
  Secretion           cell clustering (substance sources)
  RandomDeath         oncology (delete agents)
  NeuriteGrowth       neuroscience (growth cones, static trail, bifurcation)

A neighbor-using behavior declares its pair kernels in
:meth:`Behavior.neighbor_kernels`; the engine evaluates them in the step's
one fused sweep and hands the results back in
``ctx.neighbor_results[kernel.name]``. Without them (``fused_sweep=False``)
the behavior runs its own sweep through ``ctx.neighbor_apply``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from . import rand
from .agents import AgentPool, weak
from .grid import PairKernel


def resolve(value, ctx):
    """A behavior knob: a plain number, or a callable ``ctx -> value``."""
    return value(ctx) if callable(value) else value


def _col(knob):
    """A knob that scales (C, 3) rows: an ensemble's per-row knob (C,) as
    a column; a number or a 0-dim tensor as it is."""
    if isinstance(knob, torch.Tensor) and knob.dim() == 1:
        return knob[:, None]
    return knob


def _typed(ctx, pool: AgentPool, applies_to: Optional[int]) -> torch.Tensor:
    """``ctx.owned``, narrowed to one agent type when one is given."""
    if applies_to is None:
        return ctx.owned
    return ctx.owned & (pool.agent_type == applies_to)


def _unit(v: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit length (the reference's +1e-12 guard)."""
    return v / torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-12)


@dataclasses.dataclass
class BehaviorEffects:
    """What a behavior wants to change; all optional."""
    set_channels: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    birth_channels: Optional[Dict[str, torch.Tensor]] = None  # (Q, ...)
    birth_valid: Optional[torch.Tensor] = None                # (Q,) bool
    death_mask: Optional[torch.Tensor] = None                 # (C,) bool
    secretion: Optional[torch.Tensor] = None                  # (C,)


class Behavior:
    """Base class. Subclasses override ``extra_specs`` and ``__call__``;
    neighbor-using behaviors also ``neighbor_kernels``."""

    name: str = "behavior"

    def extra_specs(self) -> Dict[str, tuple]:
        """Channels this behavior needs: name → (shape_suffix, dtype, fill)."""
        return {}

    def neighbor_kernels(self) -> Tuple[PairKernel, ...]:
        """Pair kernels to register into the step's fused sweep."""
        return ()

    def __call__(self, ctx, pool: AgentPool, rng: torch.Tensor
                 ) -> BehaviorEffects:
        raise NotImplementedError


_HALF_VOLUME = 0.5 ** (1.0 / 3.0)     # d' = d / 2^(1/3) halves the volume


class GrowDivide(Behavior):
    """Grow diameter at ``rate``; split once at ``threshold_diameter``.

    The mother shrinks to half its volume; the daughter is staged at a
    random direction, one mother radius away.
    """

    name = "grow_divide"

    def __init__(self, rate: float = 1.0, threshold_diameter: float = 12.0,
                 applies_to: int | None = None):
        self.rate = rate
        self.threshold = threshold_diameter
        self.applies_to = applies_to

    def __call__(self, ctx, pool: AgentPool, rng: torch.Tensor
                 ) -> BehaviorEffects:
        mask = _typed(ctx, pool, self.applies_to)
        rate = resolve(self.rate, ctx)
        threshold = resolve(self.threshold, ctx)
        # rate·dt in Python double, then one add in the channel's dtype —
        # the reference's weak-typed scalar arithmetic
        dia = pool.diameter
        new_dia = torch.where(mask, dia + weak(rate * ctx.dt, dia), dia)
        divide = mask & (new_dia >= weak(threshold, dia))
        mother_dia = torch.where(divide, new_dia * weak(_HALF_VOLUME, dia),
                                 new_dia)
        direction = _unit(rand.normal_rows(rng, pool.capacity, 3))
        d_pos = pool.position + direction * (mother_dia * 0.5)[:, None]
        return BehaviorEffects(
            set_channels={"diameter": mother_dia},
            birth_channels={"position": d_pos, "diameter": mother_dia,
                            "agent_type": pool.agent_type},
            birth_valid=divide)


class RandomWalk(Behavior):
    """Brownian step of scale ``sigma`` (epidemiology / oncology)."""

    name = "random_walk"

    def __init__(self, sigma: float = 1.0, applies_to: int | None = None):
        self.sigma = sigma
        self.applies_to = applies_to

    def __call__(self, ctx, pool: AgentPool, rng: torch.Tensor
                 ) -> BehaviorEffects:
        mask = _typed(ctx, pool, self.applies_to)
        step = _col(resolve(self.sigma, ctx)) * rand.normal_rows(
            rng, pool.capacity, 3)
        new_pos = torch.where(mask[:, None],
                              pool.position + step * _col(ctx.dt),
                              pool.position)
        new_pos = torch.clamp(new_pos, min=ctx.domain_lo, max=ctx.domain_hi)
        return BehaviorEffects(set_channels={"position": new_pos})


# SIR agent_type encoding of the epidemiology simulation
SUSCEPTIBLE, INFECTED, RECOVERED = 0, 1, 2


class Infection(Behavior):
    """SIR infection over spatial neighbors: a susceptible agent with ≥ 1
    infected neighbor within ``radius`` becomes infected with probability
    ``beta``; an infected agent recovers after ``recovery_time`` iterations
    (timer channel)."""

    name = "infection"

    def __init__(self, radius: float = 2.0, beta: float = 0.3,
                 recovery_time: int = 50):
        self.radius = radius
        self.beta = beta
        self.recovery_time = recovery_time

    def extra_specs(self):
        return {"infect_timer": ((), torch.int32, 0)}

    def _pair_fn(self):
        r2 = self.radius * self.radius

        def pair_fn(q, nbr, valid, q_slot):
            d = nbr["position"] - q["position"][:, None, :]
            # summed x, y, z in that order, as the reference's reduction:
            # the inclusive test below decides an exact integer
            dist2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
                + d[..., 2] * d[..., 2]
            exposed = valid & nbr["alive"] \
                & (nbr["agent_type"] == INFECTED) & (dist2 <= r2)
            # an OR as a count, additive across the 9 runs; thresholded by
            # the consumer
            return {"exposed": exposed.any(-1).to(torch.int32)}

        return pair_fn

    def neighbor_kernels(self):
        return (PairKernel(name=self.name, pair_fn=self._pair_fn(),
                           out_specs={"exposed": ((), torch.int32)},
                           reads=("position", "alive", "agent_type")),)

    def __call__(self, ctx, pool: AgentPool, rng: torch.Tensor
                 ) -> BehaviorEffects:
        res = ctx.neighbor_results.get(self.name)
        if res is None:     # sequential path: its own sweep over the same
            res = ctx.neighbor_apply(self._pair_fn(),  # pre-force snapshot
                                     {"exposed": ((), torch.int32)})
        exposed = res["exposed"] > 0
        u = rand.uniform_rows(rng, pool.capacity)
        newly = ctx.owned & (pool.agent_type == SUSCEPTIBLE) & exposed \
            & (u < resolve(self.beta, ctx))
        timer = pool.extra["infect_timer"]
        recovery = resolve(self.recovery_time, ctx)
        if isinstance(recovery, torch.Tensor):
            recovery = recovery.to(timer.dtype)
        # a Python number goes in as a scalar: a tensor made from it on the
        # host would cost a copy to the card that waits for the device
        timer = torch.where(newly, recovery, timer)
        is_inf = pool.agent_type == INFECTED
        timer = torch.where(is_inf, timer - 1, timer)
        recovered = is_inf & (timer <= 0)
        new_type = torch.where(newly, INFECTED, pool.agent_type)
        new_type = torch.where(recovered, RECOVERED, new_type)
        return BehaviorEffects(set_channels={"agent_type": new_type,
                                             "extra.infect_timer": timer})


class Chemotaxis(Behavior):
    """Move up the gradient of the diffusion substance (cell clustering)."""

    name = "chemotaxis"

    def __init__(self, speed: float = 0.5):
        self.speed = speed

    def __call__(self, ctx, pool: AgentPool, rng: torch.Tensor
                 ) -> BehaviorEffects:
        g = ctx.substance_gradient(pool.position)
        norm = torch.sqrt((g * g).sum(-1, keepdim=True) + 1e-12)
        step = _col(resolve(self.speed, ctx)) * _col(ctx.dt) * g / norm
        new_pos = torch.where(ctx.owned[:, None], pool.position + step,
                              pool.position)
        new_pos = torch.clamp(new_pos, min=ctx.domain_lo, max=ctx.domain_hi)
        return BehaviorEffects(set_channels={"position": new_pos})


class Secretion(Behavior):
    """Secrete ``rate`` into the substance grid at the agent's voxel."""

    name = "secretion"

    def __init__(self, rate: float = 1.0, applies_to: int | None = None):
        self.rate = rate
        self.applies_to = applies_to

    def __call__(self, ctx, pool: AgentPool, rng: torch.Tensor
                 ) -> BehaviorEffects:
        mask = _typed(ctx, pool, self.applies_to)
        return BehaviorEffects(secretion=torch.where(
            mask, resolve(self.rate, ctx) * ctx.dt, 0.0))


class RandomDeath(Behavior):
    """Remove agents with probability ``rate`` per iteration (oncology)."""

    name = "random_death"

    def __init__(self, rate: float = 0.001, applies_to: int | None = None):
        self.rate = rate
        self.applies_to = applies_to

    def __call__(self, ctx, pool: AgentPool, rng: torch.Tensor
                 ) -> BehaviorEffects:
        mask = _typed(ctx, pool, self.applies_to)
        u = rand.uniform_rows(rng, pool.capacity)
        return BehaviorEffects(death_mask=mask & (u < resolve(self.rate,
                                                              ctx)))


# Neuroscience: growth cones extend and leave a static trail
SOMA, NEURITE_SEGMENT, GROWTH_CONE = 10, 11, 12


class NeuriteGrowth(Behavior):
    """Growth cones elongate along a persistent noisy direction, deposit a
    NEURITE_SEGMENT agent behind them every ``segment_every`` of path, and
    bifurcate with probability ``bifurcation_prob`` per iteration."""

    name = "neurite_growth"

    def __init__(self, speed: float = 1.0, noise: float = 0.15,
                 bifurcation_prob: float = 0.004, segment_every: float = 2.0):
        self.speed = speed
        self.noise = noise
        self.bif_prob = bifurcation_prob
        self.segment_every = segment_every

    def extra_specs(self):
        return {"direction": ((3,), torch.float32, 0.0),
                "path_len": ((), torch.float32, 0.0)}

    def __call__(self, ctx, pool: AgentPool, rng: torch.Tensor
                 ) -> BehaviorEffects:
        k1, k2, k3 = rand.split(rng, 3)
        c = pool.capacity
        cones = ctx.owned & (pool.agent_type == GROWTH_CONE)
        d = _unit(pool.extra["direction"]
                  + self.noise * rand.normal_rows(k1, c, 3))
        step = self.speed * ctx.dt
        new_pos = torch.where(cones[:, None], pool.position + d * _col(step),
                              pool.position)
        new_pos = torch.clamp(new_pos, min=ctx.domain_lo, max=ctx.domain_hi)
        path0 = pool.extra["path_len"]
        path = torch.where(cones, path0 + weak(step, path0), path0)

        # deposit a (soon static) segment agent at the old position
        deposit = cones & (path >= weak(self.segment_every, path0))
        path = torch.where(deposit, torch.zeros_like(path), path)

        # bifurcation: stage a second cone with a rotated direction
        bif = cones & (rand.uniform_rows(k2, c) < self.bif_prob)
        rot = _unit(d + 0.8 * rand.normal_rows(k3, c, 3))
        seg_type = torch.full_like(pool.agent_type, NEURITE_SEGMENT)
        cone_type = torch.full_like(pool.agent_type, GROWTH_CONE)
        # the queue: C deposits, then C bifurcations, committed in that order
        birth = {
            "position": torch.cat([pool.position, new_pos], 0),
            "diameter": torch.cat([pool.diameter, pool.diameter], 0),
            "agent_type": torch.cat([seg_type, cone_type], 0),
            "extra.direction": torch.cat([torch.zeros_like(d), rot], 0),
            "extra.path_len": torch.zeros(2 * c, dtype=path.dtype,
                                          device=path.device),
        }
        return BehaviorEffects(
            set_channels={"position": new_pos, "extra.direction": d,
                          "extra.path_len": path},
            birth_channels=birth, birth_valid=torch.cat([deposit, bif], 0))
