"""TREE-BASED COMPRESSION — Algorithm 1 of the paper, resident ground set
(counterpart of the resident branch of ``repro.core.tree``).

  A₀ = V;  repeat: partition A_t into m_t = ⌈|A_t|/μ⌉ balanced parts →
  run the β-nice algorithm on every part in parallel → keep the best
  partial solution seen → A_{t+1} = union of partial solutions;
  until |A_t| ≤ μ, then solve the final block on one machine.

The candidate rows, the repartition and the best-solution fold stay on the
device between rounds; only scalars cross to the host inside the loop
(|A_t| for the next machine count, the round's best value).  Partitions
come from a round plan (:mod:`repro_torch.core.plan`).

Streaming round 0, the Feistel slot scheme, checkpoints, the wave engine
and telemetry wait for ROADMAP queue 1 items 10 and 11.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.core import partition as part_lib
from repro_torch.core.distributed import RoundResult, run_round
from repro_torch.core.plan import TorchPlan
from repro_torch.device import as_tensor, resolve_device


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    k: int
    capacity: int                      # μ — max items per machine
    algorithm: str = "greedy"
    eps: float = 0.5                   # for the stochastic/threshold variants
    seed: int = 0                      # seeds the default TorchPlan
    permutation: str = "dense"         # round-0 slot scheme

    def __post_init__(self):
        assert self.capacity > self.k, (
            f"paper requires μ > k (got μ={self.capacity}, k={self.k})")
        if self.permutation != "dense":
            raise NotImplementedError(
                f"permutation={self.permutation!r} is not ported yet: "
                "ROADMAP queue 1 item 10 (sources and streaming round 0)")

    def round_bound(self, n: int) -> int:
        """Prop. 3.1: r ≤ ⌈log_{μ/k}(n/μ)⌉ + 1."""
        mu, k = self.capacity, self.k
        if mu >= n:
            return 1
        return math.ceil(math.log(n / mu) / math.log(mu / k)) + 1

    def round_bound_exact(self, n: int) -> int:
        """Worst-case rounds from the exact recurrence
        |A_{t+1}| = ⌈|A_t|/μ⌉·k — tight even when μ ≈ k."""
        mu, k = self.capacity, self.k
        t, cur = 0, n
        while cur > mu and t < 100_000:
            cur = math.ceil(cur / mu) * k
            t += 1
        return t + 1


@dataclasses.dataclass
class TreeResult:
    sel_rows: np.ndarray        # (k, d) best solution rows (zero-padded)
    sel_mask: np.ndarray        # (k,)
    value: float
    rounds: int
    oracle_calls: int
    machines_per_round: list[int]
    round_values: list[float]   # best machine value per round
    round_walls: list[float]    # seconds per round (CUDA events on the card)
    depth_per_round: list[int]  # max over the round's machines of the
    #                             dependent launches their solve paid
    solve_depth: int            # Σ depth_per_round
    total_wall_s: float         # whole tree_maximize wall clock


def _round_plan(M: int, t: int, fail_machines, device) -> torch.Tensor:
    """Failure mask of round ``t``'s M machines."""
    dead = torch.zeros((M,), dtype=torch.bool)
    for mid in fail_machines.get(t, []):
        if mid < M:
            dead[mid] = True
    return dead.to(device)


def _dispatch_round(obj, blocks, bmask, t, cfg: TreeConfig,
                    fail_machines) -> RoundResult:
    """Apply failure injection and solve one round."""
    dead = _round_plan(blocks.shape[0], t, fail_machines, blocks.device)
    return run_round(obj, blocks, bmask, k=cfg.k, alg=cfg.algorithm,
                     eps=cfg.eps, dead_mask=dead)


def _fold_round(res: RoundResult, best_rows, best_mask, best_val,
                total_calls):
    """Best-solution tracking across rounds; ties go to the lowest machine
    index and an equal value never replaces the held solution."""
    i_best = torch.argmax(res.values)              # lowest index on ties
    v_best = res.values[i_best]
    improved = v_best > best_val
    best_rows = torch.where(improved, res.sol_rows[i_best], best_rows)
    best_mask = torch.where(improved, res.sol_mask[i_best], best_mask)
    best_val = torch.where(improved, v_best, best_val)
    total_calls = total_calls + torch.sum(res.oracle_calls)
    return best_rows, best_mask, best_val, total_calls, v_best


class _RoundClock:
    """Per-round wall times: CUDA events on the card, the host clock on
    the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def walls(self) -> list[float]:
        pairs = zip(self.marks[0::2], self.marks[1::2])
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in pairs]
        return [b - a for a, b in pairs]


def tree_maximize(obj, data, cfg: TreeConfig, *, device="cuda", plan=None,
                  fail_machines: dict[int, list[int]] | None = None
                  ) -> TreeResult:
    """Run Algorithm 1 over a resident ``(n, d)`` ground set.

    Runs on the card unless ``device="cpu"``; with no card the default
    raises.  ``plan`` supplies each round's slot permutation (default
    ``TorchPlan(cfg.seed)``); ``fail_machines`` maps a round to the machine
    ids whose output is dropped.
    """
    dev = resolve_device(device)
    if obj.device != dev:
        raise ValueError(f"objective lives on {obj.device}, run asks {dev}")
    data = as_tensor(data, dev)
    plan = TorchPlan(cfg.seed) if plan is None else plan
    fail_machines = fail_machines or {}
    n, d = data.shape
    mu, k = cfg.capacity, cfg.k

    best_rows = torch.zeros((k, d), dtype=torch.float32, device=dev)
    best_mask = torch.zeros((k,), dtype=torch.bool, device=dev)
    best_val = torch.tensor(-torch.inf, device=dev)
    total_calls = torch.zeros((), dtype=torch.long, device=dev)
    rows_in = mask_in = None
    n_items = n
    machines_per_round: list[int] = []
    round_values: list[float] = []
    depth_per_round: list[int] = []
    r_bound = cfg.round_bound_exact(n)
    clock = _RoundClock(dev)
    t = 0
    t_run0 = time.perf_counter()
    while True:
        clock.mark()
        if t != 0:
            n_items = int(torch.sum(mask_in))
        L = part_lib.n_parts(n_items, mu)
        if t == 0:
            part = part_lib.balanced_partition(plan, 0, n, L, cap=mu,
                                               device=dev)
            blocks, bmask = part_lib.gather_partition(data, part)
        else:
            blocks, bmask = part_lib.repartition_rows(rows_in, mask_in, plan,
                                                      t, L, mu)
        machines_per_round.append(blocks.shape[0])
        res = _dispatch_round(obj, blocks, bmask, t, cfg, fail_machines)
        best_rows, best_mask, best_val, total_calls, v_best = _fold_round(
            res, best_rows, best_mask, best_val, total_calls)
        # union of partial solutions = next A (device-resident)
        rows_in = res.sol_rows.reshape(-1, d)
        mask_in = res.sol_mask.reshape(-1)
        round_values.append(float(v_best))
        depth_per_round.append(int(torch.max(res.depth)))
        clock.mark()
        t += 1
        if L == 1:        # that was the final single-machine round
            break
        assert t <= r_bound + 1, (
            f"round bound violated: {t} > {r_bound} (Prop 3.1)")
    return TreeResult(
        sel_rows=best_rows.cpu().numpy(), sel_mask=best_mask.cpu().numpy(),
        value=float(best_val), rounds=t, oracle_calls=int(total_calls),
        machines_per_round=machines_per_round, round_values=round_values,
        round_walls=clock.walls(), depth_per_round=depth_per_round,
        solve_depth=sum(depth_per_round),
        total_wall_s=time.perf_counter() - t_run0)
