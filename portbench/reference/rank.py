"""Exact top-k judged by scores, in float32, over a corpus drawn block by
block: the widest shortfall of a returned id's score below the k-th best
score of its query, and the rank-count rule (an id is a true top-k member
iff fewer than k corpus rows score strictly higher), which needs a second
pass once every returned id's score is known."""

from __future__ import annotations

import torch


class TopkJudge:
    """``ids`` (B, k) returned for queries ``q`` (B, D): feed every corpus
    block to :meth:`first`, then every block again to :meth:`second`."""

    def __init__(self, q: torch.Tensor, ids: torch.Tensor, k: int):
        self.q = q.float()
        self.ids = ids.long()
        self.k = k
        self.best = torch.full((q.shape[0], k), float("-inf"), device=q.device)
        # a missing id (-1) or one past the corpus scores -inf
        self.picked = torch.full(ids.shape, float("-inf"), device=q.device)
        self.higher = torch.zeros(ids.shape, dtype=torch.long, device=q.device)

    def first(self, start: int, rows: torch.Tensor) -> None:
        s = self.q @ rows.float().T
        n = rows.shape[0]
        self.best = torch.topk(torch.cat([self.best, s], dim=1), self.k, dim=1).values
        inside = (self.ids >= start) & (self.ids < start + n)
        got = torch.gather(s, 1, (self.ids - start).clamp(0, n - 1))
        self.picked = torch.where(inside, got, self.picked)

    def second(self, start: int, rows: torch.Tensor) -> None:
        s = self.q @ rows.float().T
        for j in range(self.ids.shape[1]):
            self.higher[:, j] += (s > self.picked[:, j: j + 1]).sum(dim=1)

    def shortfall(self) -> float:
        return max(0.0, (self.best[:, -1:] - self.picked).max().item())

    def recall(self) -> float:
        return (self.higher < self.k).sum().item() / self.higher.numel()
