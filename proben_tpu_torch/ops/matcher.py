"""IoU matcher with low-quality-match recovery (counterpart of
``proben_tpu/ops/matcher.py``), batched over leading dimensions.

Given a (..., M_gt, N_pred) match-quality matrix, every prediction gets its
best gt (the lowest gt index among ties) and a label from threshold
intervals; with ``allow_low_quality_matches`` every valid gt's best
predictions are forced positive. Padded gt rows (``gt_valid`` False) never
match.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def match(
    quality: torch.Tensor,  # (..., M, N) IoU of gt x predictions
    gt_valid: torch.Tensor,  # (..., M) bool
    thresholds: Sequence[float],
    labels: Sequence[int],
    allow_low_quality_matches: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(matched_idx (..., N) int64 into the gt rows, match_labels (..., N)
    int8). ``labels`` has one entry per threshold interval from the lowest
    up, each in {-1, 0, 1}. With no valid gt every prediction gets the
    lowest interval's label."""
    if len(labels) != len(thresholds) + 1:
        raise ValueError(f"{len(labels)} labels for {len(thresholds)} thresholds")
    n = quality.shape[-1]
    if quality.shape[-2] == 0:
        matched_vals = quality.new_full(quality.shape[:-2] + (n,), -1.0)
        matched_idx = torch.zeros(quality.shape[:-2] + (n,), dtype=torch.long, device=quality.device)
    else:
        # invalid gt rows can never win; torch.max returns the first maximal
        # index, as jnp.argmax does
        masked_q = torch.where(gt_valid[..., None], quality, -1.0)
        matched_vals, matched_idx = masked_q.max(dim=-2)

    match_labels = torch.full(matched_vals.shape, labels[0], dtype=torch.int8,
                              device=quality.device)
    lo = float("-inf")
    for threshold, label in zip(list(thresholds) + [float("inf")], labels):
        interval = (matched_vals >= lo) & (matched_vals < threshold)
        match_labels = torch.where(interval, label, match_labels)
        lo = threshold

    if allow_low_quality_matches and quality.shape[-2] > 0:
        # for each valid gt, the predictions tying its best quality (if > 0)
        highest = masked_q.max(dim=-1, keepdim=True).values
        is_best = (masked_q >= highest) & (highest > 0) & gt_valid[..., None]
        match_labels = torch.where(is_best.any(dim=-2), 1, match_labels)
    return matched_idx, match_labels
