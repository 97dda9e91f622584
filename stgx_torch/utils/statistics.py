"""Framewise top-1/top-5 statistics — the port of
``stgx/utils/statistics.py``."""

from __future__ import annotations

import torch

__all__ = ["Statistics", "StatisticsMultiStage"]


class Statistics:
    """Top-1/top-5 correct counts over ``(N, L, C)`` outputs, ``(N, L)`` labels.

    Returns ``(top1_pred, top5_pred, top1_correct, top5_correct, total)``;
    with a mask, padded frames count neither as correct nor toward total.
    """

    def __call__(self, outputs, labels, mask=None):
        _, top5 = torch.topk(outputs, k=min(5, outputs.shape[-1]), dim=-1)
        top1 = top5[..., 0]
        labels = labels.long()
        correct1 = top1 == labels
        correct5 = (top5 == labels[..., None]).any(dim=-1)
        if mask is not None:
            m = mask.bool()
            correct1 = correct1 & m
            correct5 = correct5 & m
            total = m.sum()
        else:
            total = labels.numel()
        return top1, top5, correct1.sum(), correct5.sum(), total


class StatisticsMultiStage(Statistics):
    """Evaluates the last stage only."""

    def __call__(self, outputs, labels, mask=None):
        return super().__call__(outputs[-1], labels, mask)
